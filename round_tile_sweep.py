"""Tile sweep of the grid round kernel (K1, csrc/grid_potts.cu) on one NVIDIA GPU.

    python3 round_tile_sweep.py

Times ``round_update(n_rounds=2)`` at 1000 x 1000, L = 4 (the main path's
launch) for each tile of TILES that fits, the default first, after checking that
every tile gives the default tile's result bit for bit.  Times are CUDA events over
20 back-to-back launches, median of 3 runs taken in turns over all tiles.
Prints the card's name and power limit, one line per tile, and a last JSON
line.  Exits non-zero without a CUDA device.
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
# (T_r, T_c): cells each block writes; (0, 0) is the kernel's default
TILES = ((0, 0), (10, 56), (8, 56), (4, 56), (24, 56), (32, 56), (16, 40), (10, 40),
         (28, 24), (20, 24), (16, 24), (24, 8), (12, 88))


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
            info[tile] = round_tile(L, N_ROUNDS, tile)
        except ValueError:
            print(f"sweep: tile {tile} does not fit the kernel's shared memory or threads: skipped")
            continue
        tiles.append(tile)
        out = launch_round_update(s, hc, vc, N_ROUNDS, tile)
        torch.cuda.synchronize()
        if not all(torch.equal(out[k], ref[k]) for k in ref):
            sys.exit(f"round_tile_sweep: tile {tile} differs from the default tile's result")
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
        rows.append({"tile": [i["rows"], i["cols"]], "loaded": [i["rows_loaded"], i["cols_loaded"]],
                     "threads": i["threads"], "smem": i["smem"], "us": us,
                     "spread_us": max(times[t]) - min(times[t]), "default": t == (0, 0)})
        print(f"sweep: T {i['rows']:2d} x {i['cols']:3d} (S {i['rows_loaded']} x "
              f"{i['cols_loaded']}, {i['threads']} threads, {i['smem']} B): {us:.1f} us/launch "
              f"({LAUNCH_BYTES / us / 1e3:.1f} GB/s, {100 * bound_us / us:.1f} % of the "
              f"{bound_us:.1f} us bound){' default' if t == (0, 0) else ''} on {card}")
    print(json.dumps({"round_tile_sweep": rows, "bound_us": bound_us, "card": card}))


if __name__ == "__main__":
    main()
