"""Parallelism on ``torch.distributed`` (port of ``med_tpu.parallel``): one
process a rank, explicit collectives (:mod:`.comm`), rank start-up
(:mod:`.launch`), data and tensor parallelism over a (data, model) mesh
(:mod:`.mesh`), LOSO folds trained as one batched program (:mod:`.folds`),
sequence parallelism for the frame families (:mod:`.seqpar`,
:mod:`.sp_cog`, :mod:`.sp_tsvn`, :mod:`.sp_train`) and pipeline
parallelism over TeCNo's refinement stages (:mod:`.pipeline`). The CLIs
reach every tier (``--mesh``, ``--fold-parallel``, ``--trial-dp``,
``--sequence-parallel``), one rank a GPU under ``torchrun``.
"""

from .mesh import make_mesh, shard_batch, shard_params, shard_state  # noqa: F401
