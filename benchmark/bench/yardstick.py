"""The benchmark's fixed measures: the card's published peaks and the
least time they allow, the classes of device kernels, the dependent
application chain and its CUDA-graph capture, and the work that the
configuration needs of the gather and of the banded blur.

Frozen copies, so the yardstick does not move when the program does:
`peaks` and `bound` of `chip_smoke.py::bound` and
`surfh_tpu_torch/utils/profiling.py` (`FP32_FLOPS_PER_S`,
`HBM_BYTES_PER_S`), `kernel_class` of `scripts/torch_profile.py`, and
`apply_chain` / `capture_chain` of `bench_torch.py`, all at commit
7f91c5f.  The work counts are this folder's own: they read the
configuration's shapes through `reference.instrument`, never the program's
plans, so they count the same work whatever implements it.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit)
FP32_FLOPS_PER_S = 67e12  # FP32 outside the tensor cores: the program runs FP32, TF32 off
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float = 0.0) -> float:
    """The least seconds the card could take: bytes over the memory rate or
    operations over the FP32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def kernel_class(name: str) -> str:
    n = name.lower()
    if "gather_rows" in n:
        return "gather_rows"
    if "wblur_banded" in n:
        return "wblur_banded"
    if "fft" in n:
        return "fft"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "sm90", "ampere", "cublas")):
        return "gemm"
    if "reduce" in n:
        return "reduction"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copy"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def apply_chain(model, x0, chain: int):
    """`chain` dependent applications ``g = Hᵗ(H x)``, ``x = x0 + g·1e-30``;
    the last `g` (no synchronisation)."""
    x = x0
    g = None
    for _ in range(chain):
        g = model.adjoint(model.forward(x))
        x = x0 + g * 1e-30
    return g


def capture_chain(model, x0, chain: int):
    """The chain captured as one CUDA graph on the static input `x0`, after
    two warm-up chains on a side stream: (graph, g), `g` recomputed in place
    by each ``graph.replay()``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            apply_chain(model, x0, chain)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = apply_chain(model, x0, chain)
    return graph, g


# ---------------------------------------------------------------------------
# the work a configuration needs, counted from its shapes


def work_counts(config: dict) -> dict:
    """Per normal application (forward and transpose, every band and
    pointing): ``gather_bytes``, the bytes the row gathers need (each output
    row written once, each source row of the band's footprint read once, Q
    columns of 4 bytes, Q the planes the configuration convolves: M·R for a
    λ-rank band of a maps unknown, else its λ window W), and, for a banded blur,
    ``blur_seconds``, the least time of its products (per product the
    larger of 2 × the response's support at ``wblur_band_rtol`` × β × rows
    over the FP32 rate, and its windows, rows and support over the memory
    rate)."""
    from ..reference import instrument

    model = config["model"]
    inp = instrument.problem_inputs(config["problem"])
    n_tpl = inp["x_shape"][0] if inp["unknown"] == "maps" else None  # a cube has no rank gate
    beta_step = inp["beta"][1] - inp["beta"][0]
    rank_rtol = float(model.get("conv_rank_rtol", 0.0)) if model.get("window_local") else 0.0
    banded = model.get("wblur_impl", "dense") == "banded"
    gather, blur = 0.0, 0.0
    for name in inp["bands"]:
        g = instrument.band_geometry(name, inp)
        q = g.n_w
        if rank_rtol > 0 and n_tpl is not None:
            r = instrument.stamp_rank(inp["stamps"][g.wslice], rank_rtol)[0]
            if n_tpl * r < g.n_w // 2:
                q = n_tpl * r
        n_out = g.n_slit * g.n_a * g.n_b
        for p in inp["pointings"]:
            idx, w = instrument.bilinear(inp["alpha"], inp["beta"], g.window_points(p).reshape(-1, 2))
            n_src = np.unique(idx[w != 0]).size
            gather += 2 * (n_src + n_out) * q * 4
        if banded:
            wpsf = g.wpsf(inp["wavel"], beta_step)
            nnz = int(instrument.band_support(wpsf, float(model["wblur_band_rtol"])).sum())
            rows = g.n_slit * g.n_a
            flops = 2.0 * rows * nnz * g.n_b
            nbytes = 4.0 * (rows * g.n_b * g.n_w + rows * len(g.wavel_det) + nnz * g.n_b)
            blur += 2 * len(inp["pointings"]) * bound(nbytes, flops)
    return {"gather_bytes": gather, "blur_seconds": blur}
