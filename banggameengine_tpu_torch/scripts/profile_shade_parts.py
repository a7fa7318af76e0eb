"""Microbenchmarks of the deferred shade's gathers, one probe at a time.

Counterpart of the JAX repository's ``scripts/profile_shade_parts.py``:
the same five probes at the same sizes (P = 1920 * 1080 pixels), from the
same seed-0 numpy inputs, each keeping its reduction so that its output is
small and can be compared with the JAX probe's:

  attr_take   - f32[28, T] taken at P indices along axis 1, summed over P
  texel_take  - u8[16, TEX] taken along axis 1, as f32, summed over P
  texel_rows  - u8[TEX, 16] taken along axis 0, as f32, summed over P
  onehot_mm   - per-tile one-hot matrix product, 510 tiles x 4096 px x
                K 80 x C 28, in f32 (TF32 off), summed over tiles and C
  pl_gather   - the u8 row gather of ``texel_rows`` through the CUDA
                kernel :func:`gather_rows.gather_rows_u8`, as f32, summed

Each probe is timed by :func:`utils.profiling.measure_throughput` (20
queued calls after 2 warm-up, CUDA events on the card).  The gather is
also timed alone, beside its plain version, the two library calls that
compute it on in-range indices (``torch.index_select`` and ``table[idx]``)
and its bound.  A probe that fails raises: nothing is caught.

    python3 -m banggameengine_tpu_torch.scripts.profile_shade_parts
    python3 -m banggameengine_tpu_torch.scripts.profile_shade_parts \\
        --device cpu --small
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from banggameengine_tpu_torch.scripts.gather_rows import (
    gather_rows_u8,
    gather_rows_u8_reference,
)
from banggameengine_tpu_torch.utils.profiling import (
    bound_ms,
    measure_throughput,
)

REPS = 20


class Sizes(NamedTuple):
    p: int         # pixels gathered
    t: int         # triangles of the attribute table
    tex: int       # texel quads of the texture pack
    n_tiles: int   # tiles of the one-hot product
    px: int        # pixels per tile
    k: int         # slots per tile


FULL = Sizes(p=1920 * 1080, t=5000, tex=8 * 256 * 256, n_tiles=510,
             px=4096, k=80)
# the tests' sizes: a gather that is no multiple of the kernel's block, a
# table of a row count that is no power of two
SMALL = Sizes(p=3001, t=50, tex=300, n_tiles=6, px=64, k=10)


def attr_take(rows, idx):
    return rows.index_select(1, idx).sum(1)


def texel_take(t, idx):
    return t.index_select(1, idx).to(torch.float32).sum(1)


def texel_rows(t, idx):
    return t.index_select(0, idx).to(torch.float32).sum(0)


def onehot_mm(slots, tabs):
    k = tabs.shape[1]
    oh = (slots[..., None] == torch.arange(k, device=slots.device)).to(
        torch.float32)
    return torch.einsum("tpk,tkc->tpc", oh, tabs).sum((0, 2))


def pl_gather(t_rows, idx):
    return gather_rows_u8(t_rows, idx).to(torch.float32).sum(0)


def inputs(sizes: Sizes = FULL) -> dict:
    """The probes' numpy inputs, drawn from one seed-0 generator in the
    JAX script's order."""
    s = sizes
    rng = np.random.default_rng(0)
    tri_rows = rng.standard_normal((28, s.t)).astype(np.float32)
    tid = rng.integers(0, s.t, s.p).astype(np.int32)
    tq = rng.integers(0, 255, (16, s.tex)).astype(np.uint8)
    tq_rows = tq.T.copy()
    tex_idx = rng.integers(0, s.tex, s.p).astype(np.int32)
    slot_idx = rng.integers(0, s.k, (s.n_tiles, s.px)).astype(np.int32)
    tables = rng.standard_normal((s.n_tiles, s.k, 28)).astype(np.float32)
    return dict(tri_rows=tri_rows, tid=tid, tq=tq, tq_rows=tq_rows,
                tex_idx=tex_idx, slot_idx=slot_idx, tables=tables)


def probes(device="cuda", sizes: Sizes = FULL) -> dict:
    """The five probes by name, each as (function, its tensors on
    ``device``)."""
    a = {k: torch.as_tensor(v, device=device)
         for k, v in inputs(sizes).items()}
    return {
        "attr_take": (attr_take, (a["tri_rows"], a["tid"])),
        "texel_take": (texel_take, (a["tq"], a["tex_idx"])),
        "texel_rows": (texel_rows, (a["tq_rows"], a["tex_idx"])),
        "onehot_mm": (onehot_mm, (a["slot_idx"], a["tables"])),
        "pl_gather": (pl_gather, (a["tq_rows"], a["tex_idx"])),
    }


def gather_bound(table, idx) -> tuple[float, str]:
    """The gather's bound: the indices and the output rows, and each
    distinct table row it reads, once; no arithmetic."""
    r, w = table.shape
    rows = torch.where(idx < 0, idx + r, idx)
    distinct = int(torch.unique(rows[(idx >= -r) & (idx < r)]).numel())
    return bound_ms(4 * idx.numel() + w * idx.numel() + w * distinct, 0)


def time_probes(runs: dict, device, reps: int = REPS) -> dict:
    """Time the probes of :func:`probes` and print one line each; returns
    ms per call by name: the five probes, and the gather alone as
    ``gather_rows_u8``, ``gather_rows_u8_reference``, the two library
    calls that compute it on in-range indices (``index_select`` and
    ``advanced_index``, ``table[idx]``) and ``library``, the faster of
    those two."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # f32-exact one-hot
        name = torch.cuda.get_device_name(device)
    else:
        name = device.type
    ms = {}
    for probe, (fn, fn_args) in runs.items():
        ms[probe] = measure_throughput(fn, *fn_args, calls=reps) * 1e3
        print(f"{probe:12s} {ms[probe]:8.3f} ms  ({name})", flush=True)

    table, idx = runs["pl_gather"][1]
    alone = {"gather_rows_u8": lambda: gather_rows_u8(table, idx),
             "gather_rows_u8_reference":
                 lambda: gather_rows_u8_reference(table, idx),
             "index_select": lambda: torch.index_select(table, 0, idx),
             "advanced_index": lambda: table[idx]}
    for key, fn in alone.items():
        ms[key] = measure_throughput(fn, calls=reps) * 1e3
    ms["library"] = min(ms["index_select"], ms["advanced_index"])
    b_ms, b_by = gather_bound(table, idx)
    print(f"{'':12s} gather alone u8{list(table.shape)} at {idx.numel()} "
          f"rows: kernel {ms['gather_rows_u8']:.4f} ms, plain "
          f"{ms['gather_rows_u8_reference']:.4f} ms, index_select "
          f"{ms['index_select']:.4f} ms, table[idx] "
          f"{ms['advanced_index']:.4f} ms, bound {b_ms:.4f} ms ({b_by})  "
          f"({name})", flush=True)
    return ms


def main(argv=None) -> dict:
    """Build the probes and time them (:func:`time_probes`)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the tests' sizes (CPU-cheap)")
    args = ap.parse_args(argv)
    runs = probes(args.device, SMALL if args.small else FULL)
    return time_probes(runs, args.device, 2 if args.small else REPS)


if __name__ == "__main__":
    main()
