"""P1 and P2 timed on the card alone, on the inputs ``chip_smoke.py``'s
phase 8 gives them.

    python3 rs_pbrt_tpu_torch/tools/probe_replay.py [--root DIR]

For each input of ``probe_cases`` (``ops/gather_probe.probe_inputs`` at
its rows and columns, seed 1) P1 (``take_rows``) and P2 (``take_loop`` at
its steps) are held bit-equal to their plain versions, then replayed
queued behind a sleeping kernel (``k1_b2_replay.queued_ms``), so that CUDA
events time the card alone and not the host's share of a call.  Beside
them, at the probe's shape: ``torch.gather`` on P1's inputs, and the
card's floor for one launch, ``torch.cuda._sleep(0)`` timed the same way.

``--root DIR`` imports ``rs_pbrt_tpu_torch`` from another checkout, to
compare two versions of the kernels on one card.

Run it as a script (not with ``-m``) so that ``--root`` decides which
package is imported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

STEPS = 1000  # the JAX probe's loop length
SEED = 1
REPS = {"take_rows": 200, "take_loop": 20}


def probe_cases() -> list:
    """(name, rows, cols, steps) of phase 8's inputs; P1 and P2 each run
    on every one (P2 with its steps).  The probe's shape; C not a power of
    two (P2's remainder path); a power of two below 32 in less than one
    block; C % 4 != 0 (P1's scalar tail and rows that start off a 16-byte
    boundary); the jump-ahead's tail (steps 0, 1, 7); and 528 rows, 4 an
    SM, where P2 is bound by its shared-memory loads, not its chains."""
    return [("probe", 16, 2048, STEPS), ("general", 16, 2000, STEPS), ("small", 3, 16, STEPS),
            ("tail", 5, 2047, STEPS), ("steps0", 16, 2048, 0), ("steps1", 16, 2048, 1),
            ("steps7", 16, 2048, 7), ("wide", 528, 2048, STEPS)]


def launch_floor_ms(queued_ms) -> float:
    """The card's time for one empty launch, queued: torch.cuda._sleep(0)."""
    return queued_ms(lambda: torch.cuda._sleep(0), REPS["take_rows"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose rs_pbrt_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from rs_pbrt_tpu_torch.ops import gather_probe as gp
    from rs_pbrt_tpu_torch.tools.k1_b2_replay import card_name, queued_ms

    variant = args.root.resolve().name
    card = card_name()
    for name, rows, cols, steps in probe_cases():
        tab, idx = gp.probe_inputs(rows, cols, seed=SEED, device="cuda")
        ms = {}
        for key, fn, plain in (("take_rows", gp.take_rows, gp.take_rows_plain),
                               ("take_loop", lambda t, i: gp.take_loop(t, i, steps),
                                lambda t, i: gp.take_loop_plain(t, i, steps))):
            got, want = fn(tab, idx), plain(tab, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: {key} differs from its plain version on "
                                     f"{int((got != want).sum())} of {got.numel()} values")
            ms[key] = queued_ms(lambda: fn(tab, idx), REPS[key])
        print(f"[probe_replay] {name} ({rows}, {cols}), {steps} steps ({variant}): P1 "
              f"{ms['take_rows']:.4f} ms, P2 {ms['take_loop']:.4f} ms on the card, each "
              f"bit-equal to its plain version ({card})", flush=True)
        if name == "probe":
            idx64 = idx.long()
            gather = queued_ms(lambda: torch.gather(tab, 1, idx64), REPS["take_rows"])
            print(f"[probe_replay] probe ({variant}): torch.gather {gather:.4f} ms, launch floor "
                  f"{launch_floor_ms(queued_ms):.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
