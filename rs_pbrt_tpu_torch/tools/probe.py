"""Card micro-benchmarks of row gathers, the question that decides how a
BVH traversal fetches its rows.

    python3 -m rs_pbrt_tpu_torch.tools.probe

The port of the JAX package's round-4 probe (``tools/tpu_probe.py``), with
the same three parts and the same printed quantities, the card's name and
power limit beside them:

1. random-row gathers ``table[idx]`` from a 2,621,447-row table in device
   memory, at row widths 8-64 and 16k-512k rows; then sorted and
   windowed indices;
2. the fixed cost of a loop of tiny steps: here a Python loop of
   launches (a lax.while_loop there), without and with one row gather a
   step;
3. the gather from on-chip memory: P1 (``ops/gather_probe.take_rows``)
   checked against its plain version, and P2 (``take_loop``, 1000
   gathers in one launch) timed as row-fetches/s.

Times come from CUDA events, the best of 3 after a warm call.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from ..device import resolve
from ..ops import gather_probe as gp

TABLE_ROWS = 2_621_447


def _ms(fn, dev, reps: int = 3) -> float:
    """Best of `reps` timed calls after a warm one, in ms (CUDA events on
    the card, the host clock on the CPU)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize(dev)
            best = min(best, ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values cut to int32 with wraparound (as int32 arithmetic)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def card_name(dev) -> str:
    """nvidia-smi's name and power limit of the card, or the device type."""
    if dev.type != "cuda":
        return str(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else torch.cuda.get_device_name(dev)


def main(device="cuda", table_rows: int = TABLE_ROWS, lanes=(16384, 131072, 524288),
         widths=(8, 16, 32, 64), seed: int = 0) -> dict:
    """Runs the three parts on `device` and prints them; returns part 3's
    numbers: p1_equal, p1_ms, gather_ms (torch.gather on P1's inputs),
    p2_ms and p2_row_fetches_per_s."""
    dev = resolve(device)
    card = card_name(dev)
    print(f"probe on {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand_idx = lambda n, hi: torch.randint(0, hi, (n,), generator=gen, device=dev)
    M = table_rows

    # --- 1: gather throughput ---
    for width in widths:
        table = torch.rand((M, width), generator=gen, device=dev)
        for R in lanes:
            idx = rand_idx(R, M)
            dt = _ms(lambda: table[idx], dev) / 1e3
            print(f"gather width={width} R={R}: {dt * 1e3:.3f}ms {R / dt / 1e6:.1f}M rows/s "
                  f"{R * width * 4 / dt / 1e9:.2f}GB/s ({card})", flush=True)
        del table
    table = torch.rand((M, 16), generator=gen, device=dev)
    R = lanes[len(lanes) // 2]
    idx_s = torch.sort(rand_idx(R, M)).values
    dt = _ms(lambda: table[idx_s], dev) / 1e3
    print(f"gather SORTED width=16 R={R}: {dt * 1e3:.3f}ms {R / dt / 1e6:.1f}M rows/s ({card})",
          flush=True)
    idx_n = rand_idx(R, min(M, 65536))
    dt = _ms(lambda: table[idx_n], dev) / 1e3
    print(f"gather 64k-WINDOW width=16 R={R}: {dt * 1e3:.3f}ms {R / dt / 1e6:.1f}M rows/s "
          f"({card})", flush=True)

    # --- 2: a loop of tiny steps, one launch each ---
    def loop(x, n):
        for _ in range(n):
            x = x * 1.000001 + 1e-9
        return x

    for R in (lanes[0], lanes[-1]):
        xx = torch.ones(R, device=dev)
        dt = _ms(lambda: loop(xx, 1000), dev) / 1e3
        print(f"launch loop 1000 iters R={R}: {dt * 1e3:.1f}ms -> {dt:.6f}s/1000 iters ({card})",
              flush=True)

    def loopg(idx, n):  # one row gather a step (the traversal's shape)
        acc = torch.zeros(idx.shape[0], device=dev)
        for _ in range(n):
            row = table[idx]
            idx = _wrap_i32(idx * gp.LCG_MUL + gp.LCG_ADD) % M
            acc = acc + row[:, 0]
        return acc

    for R in lanes:
        idx = rand_idx(R, M)
        dt = _ms(lambda: loopg(idx, 100), dev) / 1e3
        print(f"launch loop 100 iters w/ gather R={R}: {dt * 1e3:.1f}ms "
              f"({R * 100 / dt / 1e6:.1f}M gathered-rows/s) ({card})", flush=True)
    del table

    # --- 3: gathers from on-chip memory, P1 and P2 ---
    tab, idx = gp.probe_inputs(16, 2048, seed, dev)
    out = gp.take_rows(tab, idx)
    p1_equal = bool(torch.equal(out, gp.take_rows_plain(tab, idx)))
    print(f"P1 take_rows (16,2048): equal to its plain version={p1_equal} ({card})",
          flush=True)
    idx64 = idx.long()
    res = dict(p1_equal=p1_equal, p1_ms=_ms(lambda: gp.take_rows(tab, idx), dev),
               gather_ms=_ms(lambda: torch.gather(tab, 1, idx64), dev))
    res["p2_ms"] = _ms(lambda: gp.take_loop(tab, idx), dev)
    res["p2_row_fetches_per_s"] = gp.STEPS * tab.shape[1] / (res["p2_ms"] / 1e3)
    print(f"P1 {res['p1_ms']:.4f}ms, torch.gather {res['gather_ms']:.4f}ms; P2 gather loop: "
          f"{res['p2_ms']:.3f}ms for {gp.STEPS}x(16,2048) -> "
          f"{res['p2_row_fetches_per_s'] / 1e6:.0f}M row-fetches/s ({card})", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["p1_equal"] else 1)
