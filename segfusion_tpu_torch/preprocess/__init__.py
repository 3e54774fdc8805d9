"""Offline watertight-mesh preprocessing, the port of ``tools/preprocess``:
``scale`` (into the unit cube), ``fuse`` (rendered views -> TSDF fusion on
the card -> marching cubes) and ``simplify`` (QEM decimation), each
runnable as ``python -m segfusion_tpu_torch.preprocess.<step>`` with the
tools' flags and defaults."""
