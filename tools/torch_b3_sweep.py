#!/usr/bin/env python3
"""B3's square and batched launch at every super-tile it can take, on one CUDA card.

For each shape of ``chip_smoke.DOMINANCE_BATCHES`` and B3's single launches
at n 1998, 11024 and 20000 (m 3), every member a draw of
``chip_smoke.stress_fitness`` (ties, NaN, ±0.0, ±inf and +inf rows), and
for each super-tile of ``kernels/dominance.py::SQUARE_TILES``: a launch
of the kernel's C entry on that super-tile's plan (``tile_plan``), held
bit for bit against ``packed_dominance_batched_reference``, then timed by
CUDA events (mean of 20 launches after 3) and by CUDA-graph replays (50
launches a graph, no host gap: the device's µs a launch), beside the
super-tile the wrapper's ``launch_plan`` chooses. It reads which
super-tile each shape wants, for ``FILL_BLOCKS``. Run from a checkout::

    python3 tools/torch_b3_sweep.py [--out PATH]

The card's name and power limit come first; the last line of standard
output is one JSON object with every shape's times.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    import chip_smoke
    from evox_tpu_torch.kernels import _build
    from evox_tpu_torch.kernels import dominance as kd
    from tools.torch_kernel_ab import B3_SINGLES, _graph_us

    if not torch.cuda.is_available():
        print("torch_b3_sweep: no CUDA card", file=sys.stderr)
        return 1
    entry_point = _build.function("dominance", "evox_packed_dominance_batched", kd._SQUARE_ARGS)

    def launch(fit, plan):
        b, n, m = fit.shape
        packed = fit.new_empty((b, plan["n_words"], n), dtype=torch.int32)
        count = fit.new_empty((b, n), dtype=torch.int32)
        err = entry_point(fit.data_ptr(), b, n, m, packed.data_ptr(), count.data_ptr(),
                          torch.cuda.current_stream().cuda_stream, plan["instance"],
                          plan["tile_words"], math.prod(plan["grid"]))
        _build.check_launch("dominance", err, "packed_dominance")
        return packed, count

    smi = chip_smoke._nvidia_smi()
    print(smi, flush=True)
    result = {"nvidia_smi": smi, "shapes": {}}
    shapes = [tuple(s) for s in chip_smoke.DOMINANCE_BATCHES] + [(1, n, m) for n, m in B3_SINGLES]
    for b, n, m in shapes:
        fit = torch.stack([chip_smoke.stress_fitness(torch, n, m, 1000 * b + n + r, "cpu")
                           for r in range(b)]).cuda()
        want = kd.packed_dominance_batched_reference(fit)
        entry = {"chosen": kd.launch_plan(n, m, b)["tile_words"], "tiles": {}}
        for tile in kd.SQUARE_TILES[m <= 4]:
            plan = kd.tile_plan(n, m, b, tile)
            call = lambda: launch(fit, plan)  # noqa: E731
            chip_smoke.compare_exact(f"B3 ({b}, {n}, {m}) at {tile} x {tile} words", call(), want)
            entry["tiles"][tile] = {"grid": plan["grid"], "working_blocks": plan["working_blocks"],
                                    "ms": chip_smoke._time_ms(call, 3, 20),
                                    "graph_us": _graph_us(torch, call)}
        result["shapes"][f"{b}x{n}x{m}"] = entry
        print(f"[b3 sweep] ({b}, {n}, {m}) {json.dumps(entry)}", flush=True)
        del fit, want
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
