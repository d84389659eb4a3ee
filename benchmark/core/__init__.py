"""The benchmark's general code: it finds each cell's configuration, traffic
mix, driver, reference and per-layer metrics by the names in
``BENCHMARK.json``, so that a cell, a mix or a metric is added as files."""
