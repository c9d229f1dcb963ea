#!/usr/bin/env python3
"""A/B timing of the port's host-bound paths between two checkouts, on
one GPU: the unmeshed LM decode step and the signature kernels' wrapper
calls.

Run from the root of a checkout, with a second checkout (for example the
parent commit, ``git archive HEAD~1 | tar -x -C build/parent``) at DIR:

    python3 host_ab.py --parent build/parent [--out build/host_ab]

Each turn is a process of its own that imports ``repro_torch`` from one
checkout's ``src``, in turns parent, change, change, parent.  A turn
  * drives ``chip_smoke.py`` phase 10's decode runs through
    ``build_cell`` / ``init_inputs`` / ``CellProgram.step`` at published
    widths in bfloat16, depth, batch and cache cut as phase 10 cuts them
    (``RUNS``): a warm-up step, then CUDA events around ``steps - 1``
    steps, back to back (the step is host-bound: the events time the
    host's launches too), the process's CPU seconds over the same steps,
    and one more step under ``torch.profiler`` (its kernels' launches and
    summed device time);
  * calls ``minhash2u_cuda`` and ``sigbag_cuda`` at a ``serve_p99``
    request's shapes (512 rows x 128 nonzeros, k = 64, b = 8; 64 slots,
    2^b = 256, d = 32, float32) ``CALLS`` times back to back after a
    warm-up, host clock to a synchronize: a launch takes a few µs on the
    device, so this is the host's time a call.
The weights and inputs come from one seed, so both checkouts must give
the same next tokens, cache, signatures and bags, bit for bit; the
script fails otherwise.  Prints one line per turn and a JSON summary as
its last line (also written to ``--out``/host_ab.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 1234
CALLS = 2000
# arch: (layers, decode cell, batch, steps) -- chip_smoke.py's LM_RUNS
RUNS = {
    "deepseek-7b": (30, "decode_32k", 2, 64),
    "llama4-scout-17b-a16e": (4, "long_500k", 1, 16),
    "deepseek-v3-671b": (4, "decode_32k", 8, 16),
}


def worker(src: str) -> None:
    sys.path.insert(0, src)
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_cell
    from repro_torch.configs.base import InputSpec
    from repro_torch.launch.steps import build_cell, init_inputs
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    i32 = torch.int32
    out = {}
    for arch, (depth, cell, batch, steps) in RUNS.items():
        prog = build_cell(arch, cell, smoke=False, device=dev)
        cfg = prog.config
        cfg = dataclasses.replace(cfg, n_layers=depth, n_dense_layers=min(
            cfg.n_dense_layers, depth - 1 if cfg.is_moe else 0))
        L = get_cell(arch, cell).dims["seq"]
        cache = {key: {name: InputSpec(tuple(t.shape), t.dtype)
                       for name, t in stack.items()}
                 for key, stack in tfm.cache_shapes(cfg, batch, L).items()}
        prog = dataclasses.replace(prog, config=cfg, input_specs={
            "cache": cache, "tokens": InputSpec((batch,), i32),
            "pos": InputSpec((), i32)})
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = prog.init_params(gen)
        inputs = init_inputs(prog, gen)
        cache, tokens = inputs["cache"], inputs["tokens"]
        pos = torch.ones((), dtype=i32, device=dev)
        tokens, cache = prog.step(model, {"cache": cache, "tokens": tokens,
                                          "pos": pos})      # warm-up step
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cpu0 = time.process_time()
        start.record()
        for _ in range(steps - 1):
            pos = pos + 1
            tokens, cache = prog.step(model, {"cache": cache,
                                              "tokens": tokens, "pos": pos})
        end.record()
        cpu_ms = (time.process_time() - cpu0) * 1e3 / (steps - 1)
        end.synchronize()
        step_ms = start.elapsed_time(end) / (steps - 1)
        nxt = {"cache": cache, "tokens": tokens, "pos": pos + 1}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tokens, cache = prog.step(model, nxt)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        digest = sum(float(layer.sum(dtype=torch.float64))
                     for stack in cache.values() for leaf in stack.values()
                     for layer in leaf)          # a layer at a time
        out[arch] = {"ms": step_ms, "cpu_ms": cpu_ms,
                     "launches": sum(e.count for e in kern),
                     "kernel_ms": sum(e.self_device_time_total
                                      for e in kern) / 1e3,
                     "tokens": tokens.tolist(), "cache_sum": digest,
                     "steps": steps, "layers": depth, "batch": batch,
                     "cache_len": L}
        del model, inputs, cache, tokens, nxt, prof
        torch.cuda.empty_cache()
    from repro_torch.kernels.minhash import minhash2u_cuda
    from repro_torch.kernels.sigbag import sigbag_cuda
    g = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda hi, shape: torch.randint(0, hi, shape, generator=g,
                                           device=dev, dtype=i32)
    idx, cnt = rand(1 << 24, (512, 128)), rand(127, (512,)) + 1
    a1, a2 = rand(2**31 - 1, (64,)), rand(2**31 - 1, (64,)) | 1
    tok = rand(256, (512, 64))
    table = torch.randn((64, 256, 32), generator=g, device=dev)
    calls = {"minhash2u": lambda: minhash2u_cuda(idx, cnt, a1, a2, s=24,
                                                  b=8),
             "sigbag": lambda: sigbag_cuda(tok, table)}
    for name, call in calls.items():
        for _ in range(100):
            res = call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        out[name] = {"us": (time.perf_counter() - t0) / CALLS * 1e6,
                     "sum": float(res.sum(dtype=torch.float64))}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--out", default="build/host_ab")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for side in ("parent", "change", "change", "parent"):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.join(trees[side], "src")],
            capture_output=True, text=True, cwd=trees[side])
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{side} turn failed ({res.returncode})")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for arch in RUNS:
            r = got[arch]
            print(f"{side:6} {arch}: {r['ms']:.2f} ms a step (CUDA events "
                  f"over {r['steps'] - 1} steps), process CPU "
                  f"{r['cpu_ms']:.2f} ms a step; profiled step "
                  f"{r['launches']} launches, {r['kernel_ms']:.2f} ms of "
                  f"kernels", flush=True)
        print(f"{side:6} host time a call over {CALLS}: minhash2u "
              f"{got['minhash2u']['us']:.2f} us, sigbag "
              f"{got['sigbag']['us']:.2f} us", flush=True)
        turns.append((side, got))
    first = turns[0][1]
    same = lambda r, f: ({k: r[k] for k in ("tokens", "cache_sum", "sum")
                          if k in r} == {k: f[k] for k in ("tokens",
                                                           "cache_sum", "sum")
                                         if k in f})
    for side, got in turns[1:]:
        for name, r in got.items():
            if not same(r, first[name]):
                raise SystemExit(f"{name}: {side}'s outputs differ from the "
                                 "parent's")
    keys = ("ms", "cpu_ms", "launches", "kernel_ms", "us")
    summary = {"device": smi, "turns": [
        {"side": side, **{a: {k: r[k] for k in keys if k in r}
                          for a, r in got.items()}}
        for side, got in turns]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "host_ab.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("outputs equal in every turn")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
