"""Geometry sweep of the grid round kernel (K1, csrc/grid_potts.cu) on one NVIDIA GPU.

    python3 round_tile_sweep.py

Each block of the round kernel writes the T_r rows of one segment of a
T_c-column strip, streaming the segment's T_r + 2P rows down the strip's
T_c + 2P loaded columns through a ring of rows in shared memory (P = 4 at two
rounds a launch).  This script times ``round_update(n_rounds=2)`` at 1000 x
1000, L = 4 (the main path's launch) for each geometry ``(T_r, T_c)`` of
TILES that fits, the kernel's own first, after checking that every geometry
gives the kernel's own result bit for bit.  A zero takes the kernel's own
choice for that dimension (T_r splits the rows so that the strips times the
segments fill one wave).  Times are CUDA events over 20 back-to-back launches,
median of 3 runs taken in turns over all geometries.  Prints the card's name
and power limit, one line per geometry (with its ring, threads, shared
memory, blocks per SM and waves, as ``round_tile`` reports them), and a last
JSON line.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from lp_mp_tpu_torch import GridPottsModel, random_grid
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops.grid_kernels import launch_round_update, round_tile

H, W, L, SEED, N_ROUNDS, REPS = 1000, 1000, 4, 1, 2, 20
LAUNCH_BYTES = 4 * L * (H * W + 2 * H * (W - 1) + 2 * (H - 1) * W) * 2 \
    + 4 * (H * (W - 1) + (H - 1) * W)      # state read and written, costs read
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
# (T_r, T_c): rows of a segment and columns of a strip each block writes; a
# zero is the kernel's own choice there.  Segments from 36 to 250 rows in the
# kernel's own strips, then strips of 24 to 120 columns with their own rows.
TILES = ((0, 0), (36, 0), (48, 0), (56, 0), (84, 0), (125, 0), (250, 0),
         (0, 24), (0, 40), (0, 88), (0, 120), (0, 8))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("round_tile_sweep: torch.cuda.is_available() is false: this script runs only "
                 "on a machine with an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    _cuda_build.library()
    m = GridPottsModel(*random_grid(H, W, L, seed=SEED), device="cuda", dtype=torch.float32)
    m.run_fast(3)
    s, hc, vc = m.state, m.hc, m.vc
    ref = launch_round_update(s, hc, vc, N_ROUNDS)
    fns, info = {}, {}
    tiles = []
    for tile in TILES:
        try:
            info[tile] = round_tile(L, N_ROUNDS, H, W, tile)
        except ValueError:
            print(f"sweep: geometry {tile} does not fit the kernel's shared memory or threads: "
                  f"skipped")
            continue
        tiles.append(tile)
        out = launch_round_update(s, hc, vc, N_ROUNDS, tile)
        torch.cuda.synchronize()
        if not all(torch.equal(out[k], ref[k]) for k in ref):
            sys.exit(f"round_tile_sweep: geometry {tile} differs from the kernel's own result")
        fns[tile] = lambda tile=tile: launch_round_update(s, hc, vc, N_ROUNDS, tile)
    times = {t: [] for t in tiles}
    for order in (tiles, tiles[::-1], tiles):
        for t in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fns[t]()
            end.record()
            end.synchronize()
            times[t].append(start.elapsed_time(end) / REPS * 1e3)
    bound_us = LAUNCH_BYTES / HBM_BYTES_PER_S * 1e6
    rows = []
    for t in tiles:
        us, i = statistics.median(times[t]), info[t]
        rows.append({"tile": list(t), "geometry": i, "us": us,
                     "spread_us": max(times[t]) - min(times[t]), "default": t == (0, 0)})
        print(f"sweep: {i['rows']:4d} rows x {i['cols']:3d} columns written ({i['rows_loaded']} "
              f"x {i['cols_loaded']} streamed; ring {i['ring_rows']} rows, {i['bands_ahead']} "
              f"bands ahead; {i['threads']} threads, {i['smem']} B, {i['blocks_per_sm']} "
              f"blocks/SM; {i['strips']} x {i['segments']} blocks, {i['waves']} wave(s)): "
              f"{us:.1f} us/launch ({LAUNCH_BYTES / us / 1e3:.1f} GB/s, "
              f"{100 * bound_us / us:.1f} % of the {bound_us:.1f} us bound)"
              f"{' default' if t == (0, 0) else ''} on {card}")
    print(json.dumps({"round_tile_sweep": rows, "bound_us": bound_us, "card": card}))


if __name__ == "__main__":
    main()
