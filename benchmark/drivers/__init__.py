"""Drivers: the general code of a kind of traffic. A traffic mix's file
names its driver; the driver builds the system under test from the
configuration file, makes the mix's inputs from the seed, drives the
measured window and gathers what ``correct`` is decided from."""
