"""Bulk similarity join: device-streamed SimRank kNN-graph construction
(port of ``repro/join``, one device).

Sweep a source set through the Horner push in fixed-shape tiles, reduce
each tile with a top-k on the device, and materialize a versioned
:class:`KnnGraph` artifact that ``QueryEngine.knn`` reads instead of
issuing per-node queries.
"""
from repro_torch.join.artifact import (CKPT_FORMAT_VERSION,  # noqa: F401
                                       KNN_FORMAT_VERSION, KnnGraph)
from repro_torch.join.sweep import (JoinConfig,  # noqa: F401
                                    compile_count, run_join)
