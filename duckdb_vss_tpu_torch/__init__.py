"""duckdb_vss_tpu_torch — the PyTorch/CUDA port of duckdb_vss_tpu.

A second package beside the JAX one, held against it function by
function. It runs the HNSW main path (bulk build, then search through
the fused beam kernel) on one NVIDIA H100; the fused beam is a CUDA
kernel written for sm_90a (csrc/fused_beam.cu). It imports neither JAX
nor the JAX package.

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise. Only a caller that passes ``device="cpu"`` gets the CPU, as
the tests do.
"""

import torch as _torch

# The exact paths (flat scan, final rerank) need true f32 products: the
# JAX package runs them at Precision.HIGHEST (ops/distance.py), and TF32
# keeps only ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from duckdb_vss_tpu_torch.utils.config import (  # noqa: E402,F401
    BinderError,
    HNSWConfig,
    MetricKind,
)

__version__ = "0.1.0"
