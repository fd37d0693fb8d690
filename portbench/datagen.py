"""The rows and queries of a run, made on the device from ``--seed``.

Frozen copy, rewritten in torch, of bench.py's SIFT-shaped clustered
generator (also ``duckdb_vss_tpu_torch/tools/build_peak.make_data``):
``n_centers`` standard normal centres in d dimensions, each row a
uniformly drawn centre plus ``sigma`` times standard normal noise;
queries are drawn the same way. Each kind of data has a stream of its
own, so the rows do not change with the number of queries or appended
rows a mix asks for, and the same seed gives the same data on any card.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"centres": 0, "rows": 1, "queries": 2, "insert": 3}
CHUNK = 1 << 20


def stream_generator(seed: int, stream: str, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of ``seed`` (any
    non-negative integer, also past 2**32)."""
    state = np.random.SeedSequence([int(seed), STREAMS[stream]])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def centres(cfg: dict, seed: int, device) -> torch.Tensor:
    gen = cfg["generator"]
    g = stream_generator(seed, "centres", device)
    return torch.randn((gen["n_centers"], cfg["dims"]), generator=g,
                       device=device, dtype=torch.float32)


def clustered(cfg: dict, seed: int, stream: str, n: int, device,
              cents: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` rows of the stream, [n, dims] float32 on ``device``, made
    in chunks of CHUNK rows."""
    cents = centres(cfg, seed, device) if cents is None else cents
    sigma = float(cfg["generator"]["sigma"])
    g = stream_generator(seed, stream, device)
    out = torch.empty((n, cfg["dims"]), dtype=torch.float32, device=device)
    for off in range(0, n, CHUNK):
        m = min(CHUNK, n - off)
        asg = torch.randint(0, cents.shape[0], (m,), generator=g,
                            device=device)
        noise = torch.randn((m, cfg["dims"]), generator=g, device=device,
                            dtype=torch.float32)
        out[off:off + m] = cents[asg] + sigma * noise
    return out
