#!/usr/bin/env python3
"""A/B timing of the port's OPH, minhash, packed-match and signature
embedding-bag CUDA kernels between two checkouts, on one GPU.

Run from the root of a checkout, with a second checkout (for example the
parent commit, ``git archive HEAD~1 | tar -x -C build/parent``) at DIR:

    python3 kernel_ab.py --parent build/parent [--out build/ab]

It builds ``src/repro_torch/csrc/oph.cu``, ``minhash.cu``,
``hamming.cu`` and ``sigbag.cu`` of both checkouts (their C interfaces
must match: ``sigbag_cuda`` calls ``sigbag_shard_launch``, which a
checkout older than the row-shard entry lacks, and ``packed_match_cuda``
calls ``packed_match_tiled_launch``, which a checkout older than the
tuning table lacks; such a parent's library still loads) and calls each
through THIS checkout's wrappers, at their default launch shapes,
swapping
the loaded library, in turns parent, change, change, parent, at the main
paths' shapes:

  * ``oph2u`` and ``oph4u`` (k = 512, s = 24, raw values), ``minhash4u``
    and ``minhash2u``, one 10,000-row chunk at the paper's
    webspam (trigram) width, k = 500, s = 24, b = 8 (``minhash4u`` by
    CUDA events around one launch, median of 7; the other three by a
    CUDA graph of 20 launches, and by events around one launch beside
    it), and ``minhash2u`` at the Wide & Deep frontend's shape, 512
    rows x 128 nonzeros, k = 64 (a CUDA graph of 20 launches);
  * ``packed_match``, k = 512, b = 8: one 256-query x 4,096-doc
    exact-flush block (a CUDA graph of 20 launches, and eager launches
    back to back) and 256 queries x 677,399 docs in one launch;
  * ``sigbag`` at the Wide & Deep frontend's shapes (64 slots, 2^b =
    256, d = 32): a ``serve_p99`` request of 512 rows, float32 and
    bfloat16 tables (a CUDA graph of 20 launches), and ``serve_bulk``'s
    262,144 rows, float32 by CUDA events around one launch (median of 7;
    the window holds the host's launch time too) and both types by a
    CUDA graph of 20 launches; and the frontend as served, ``minhash2u``
    (512 rows x 128 nonzeros, k = 64) into ``sigbag`` (a graph of 20);
  * ``minhash2u`` / ``minhash4u`` on the same chunk with the fused pack
    (b = 8) at k = 500 (a ragged last warp, the main path) and k = 512
    (whole groups), and at the batch-learning path's k = 200, b = 0 on
    the tuned 64 threads.

Every output of the change is held bit-exact against the parent's (but
the packed words at k = 500, which a parent from before the ragged pack
leaves partly unwritten: the change's are held to ``pack_codes`` of its
own unpacked k = 500 codes), and
the change against the plain versions on ``chip_smoke.py``'s edge chunks
(``minhash4u``, ``minhash2u``, ``oph2u`` / ``oph4u``), packed-match odd
shapes and ``sigbag`` edge set.  To compare another design, pass its checkout as ``--parent``
(one call can run the script more than once).  It prints each kernel's
registers and spills (``nvcc -Xptxas -v``), writes both checkouts' SASS
to ``OUT/<tree>-<source>.sass`` and prints each kernel's SASS opcode
counts.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import argparse
import collections
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (timing helpers, bounds, constants)

SOURCES = ("oph", "minhash", "hamming", "sigbag")
# sigbag.cu's instantiations at the serving cells' shapes (d = 32): the
# ptxas and SASS summaries print these and leave out the other ~30
SIGBAG_SHOWN = ("sigbag_stagedI3F32Li8E", "sigbag_stagedI4BF16Li4E",
                "sigbag_directI3F32Li8ELi16E", "sigbag_directI4BF16Li4ELi16E")


def shown(fn: str) -> bool:
    return "sigbag" not in fn or any(x in fn for x in SIGBAG_SHOWN)


def build_tree(root: Path, out: Path, tag: str, nvcc: str) -> dict:
    """nvcc every source of ``root``'s csrc into ``out``, all at once, with
    this checkout's flags; returns {source: loaded ctypes library}, and
    prints ptxas's report of the kernels ``shown`` picks."""
    from repro_torch.kernels import build
    csrc = root / "src" / "repro_torch" / "csrc"
    procs, fn = {}, "?"
    for name in SOURCES:
        so = out / f"{tag}-lib{name}.so"
        cmd = [nvcc, *build.flags(name), "-Xptxas", "-v", "-I", str(csrc),
               "-o", str(so), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}.cu failed:\n{text}")
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif ("registers" in line or "spill" in line) and shown(fn):
                print(f"[ptxas {tag} {name}] {fn}: {line.split('info    :')[-1].strip()}")
        libs[name] = build.load(name, so)
        sass = subprocess.run(["cuobjdump", "-sass", str(so)],
                              capture_output=True, text=True).stdout
        (out / f"{tag}-{name}.sass").write_text(sass)
        for fn, ops in opcode_counts(sass).items():
            if not shown(fn):
                continue
            top = ", ".join(f"{o} {n}" for o, n in ops.most_common(24))
            print(f"[sass {tag}] {fn}: {sum(ops.values())} instructions: {top}")
    return libs


def opcode_counts(sass: str) -> dict:
    """{function: Counter of opcodes} of a ``cuobjdump -sass`` listing."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn is not None:
            out[fn][m.group(1)] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.bbit import pack_codes
    from repro_torch.core.u32 import from_numpy
    from repro_torch.data.sparse import from_lists
    from repro_torch.data.synthetic import DatasetSpec, generate_sets
    from repro_torch.kernels import build
    from repro_torch.kernels import hamming as kham
    from repro_torch.kernels import oph as koph
    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels import sigbag as ksig
    from repro_torch.train.online import make_family

    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {tag: build_tree(root, args.out, tag, build.nvcc())
            for tag, root in (("parent", args.parent.resolve()),
                              ("change", ROOT))}
    dev = torch.device("cuda")

    def use(tag):
        for name in SOURCES:
            build.install(name, libs[tag][name])

    # -- inputs ---------------------------------------------------------------
    spec = DatasetSpec("webspam_trigram_width", n=12_500, D=2**24,
                       avg_nnz=3_728, n_prototypes=6, overlap=0.7, seed=7)
    (sets, labels), _ = generate_sets(spec)
    chunk = from_lists(sets[:cs.CHUNK], labels[:cs.CHUNK], device=dev)
    idx, cnt = chunk.indices, chunk.nnz_per_row()
    total_nnz, n = int(cnt.sum()), idx.shape[0]
    gen = torch.Generator().manual_seed(cs.SEED)
    f4 = make_family("4u", cs.K_PAPER, cs.S, generator=gen, device=dev)
    f2 = make_family("2u", cs.K_PAPER, cs.S, generator=gen, device=dev)
    f2r = make_family("2u", 64, cs.S, generator=gen, device=dev)
    o2 = make_family("oph", cs.K_OPH, cs.S, densify="rotation",
                     generator=gen, device=dev).base
    o4 = make_family("oph-4u", cs.K_OPH, cs.S, densify="rotation",
                     generator=gen, device=dev).base
    bin_bits = cs.K_OPH.bit_length() - 1
    rng = np.random.default_rng(cs.SEED + 51)
    rid = from_numpy(rng.integers(0, 2**cs.S, (512, 128)), dev)
    rcnt = torch.from_numpy(rng.integers(1, 129, 512).astype(np.int32)).to(dev)
    n_docs, words = cs.N_DOCS, cs.K_IDX * cs.B // 32
    codes = torch.randint(0, 4, (n_docs, cs.K_IDX), dtype=torch.int32,
                          device=dev, generator=torch.Generator(
                              device=dev).manual_seed(cs.SEED + 52))
    corpus = torch.cat([pack_codes(codes[i:i + 65_536], cs.B)
                        for i in range(0, n_docs, 65_536)])
    del codes
    q = corpus[:cs.N_QUERIES].clone()
    blk = corpus[:cs.BLOCK]
    sgen = torch.Generator(device=dev).manual_seed(cs.SEED + 53)
    sig_f32 = torch.randn(64, 256, 32, generator=sgen, device=dev) * 0.01
    sig_tables = {"float32": sig_f32, "bfloat16": sig_f32.to(torch.bfloat16)}
    sig_tok = {n: torch.randint(0, 256, (n, 64), dtype=torch.int32,
                                generator=sgen, device=dev)
               for n in (512, cs.BULK_ROWS)}

    oph_bound = {four_u: cs.bound(
        cs.oph_bytes(total_nnz, n, cs.K_OPH, four_u),
        cs.oph_ops(total_nnz, n, cs.K_OPH, four_u, 0)) for four_u in (0, 1)}
    cases = {
        "oph2u k=512": (
            lambda: koph.oph2u_cuda(idx, cnt, o2.a1, o2.a2, s=cs.S,
                                    bin_bits=bin_bits, code_b=0),
            "graph", oph_bound[0]),
        "oph4u k=512": (
            lambda: koph.oph4u_cuda(idx, cnt, o4.a, s=cs.S,
                                    bin_bits=bin_bits, code_b=0),
            "graph", oph_bound[1]),
        "minhash4u k=500": (
            lambda: kmin.minhash4u_cuda(idx, cnt, f4.a, s=cs.S, b=cs.B),
            "events",
            cs.bound(cs.minhash_bytes(total_nnz, n, cs.K_PAPER, True),
                     cs.minhash_ops(total_nnz, n, cs.K_PAPER, True, cs.B,
                                    False))),
        "minhash2u k=500": (
            lambda: kmin.minhash2u_cuda(idx, cnt, f2.a1, f2.a2, s=cs.S,
                                        b=cs.B),
            "graph",
            cs.bound(cs.minhash_bytes(total_nnz, n, cs.K_PAPER, False),
                     cs.minhash_ops(total_nnz, n, cs.K_PAPER, False, cs.B,
                                    False))),
        "minhash2u recsys 512x128 k=64": (
            lambda: kmin.minhash2u_cuda(rid, rcnt, f2r.a1, f2r.a2, s=cs.S,
                                        b=cs.B),
            "graph", None),
        "packed_match Q=256 N=4096": (
            lambda: kham.packed_match_cuda(q, blk, k=cs.K_IDX, code_bits=cs.B),
            "graph",
            cs.bound(cs.match_bytes(cs.N_QUERIES, cs.BLOCK, words, False),
                     cs.match_ops(cs.N_QUERIES, cs.BLOCK, cs.K_IDX, cs.B,
                                  False))),
        "packed_match Q=256 N=4096 eager": (
            lambda: kham.packed_match_cuda(q, blk, k=cs.K_IDX, code_bits=cs.B),
            "eager", None),
        "packed_match Q=256 N=677399": (
            lambda: kham.packed_match_cuda(q, corpus, k=cs.K_IDX,
                                           code_bits=cs.B),
            "events",
            cs.bound(cs.match_bytes(cs.N_QUERIES, n_docs, words, False),
                     cs.match_ops(cs.N_QUERIES, n_docs, cs.K_IDX, cs.B,
                                  False))),
    }
    for label, dtype, n, how in (
            ("512x64 float32", "float32", 512, "graph"),
            ("512x64 bfloat16", "bfloat16", 512, "graph"),
            ("262144x64 float32", "float32", cs.BULK_ROWS, "events"),
            ("262144x64 float32 by graph", "float32", cs.BULK_ROWS, "graph"),
            ("262144x64 bfloat16 by graph", "bfloat16", cs.BULK_ROWS, "graph")):
        tok, table = sig_tok[n], sig_tables[dtype]
        cases[f"sigbag {label}"] = (
            lambda tok=tok, table=table: ksig.sigbag_cuda(tok, table), how,
            cs.sigbag_bound(torch, tok, table)[:2])
    # the recsys frontend as served: minhash2u's codes into sigbag
    cases["frontend minhash2u + sigbag 512 float32"] = (
        lambda: ksig.sigbag_cuda(
            kmin.minhash2u_cuda(rid, rcnt, f2r.a1, f2r.a2, s=cs.S, b=cs.B),
            sig_tables["float32"]), "graph", None)

    # the fused pack on the chunk, and the tuned batch-learning launches
    gen = torch.Generator().manual_seed(cs.SEED + 54)
    for k in (cs.K_PAPER, cs.K_MIN, cs.K_BATCH):
        g2 = make_family("2u", k, cs.S, generator=gen, device=dev)
        g4 = make_family("4u", k, cs.S, generator=gen, device=dev)
        b, kw = ((0, dict(threads=64)) if k == cs.K_BATCH
                 else (cs.B, dict(pack=True)))
        tag = "b=0 threads=64" if k == cs.K_BATCH else "pack"
        cases[f"minhash2u k={k} {tag}"] = (
            lambda g2=g2, b=b, kw=kw: kmin.minhash2u_cuda(
                idx, cnt, g2.a1, g2.a2, s=cs.S, b=b, **kw), "graph",
            cs.bound(cs.minhash_bytes(total_nnz, n, k, False, b and cs.B),
                     cs.minhash_ops(total_nnz, n, k, False, b, b > 0)))
        cases[f"minhash4u k={k} {tag}"] = (
            lambda g4=g4, b=b, kw=kw: kmin.minhash4u_cuda(
                idx, cnt, g4.a, s=cs.S, b=b, **kw), "events",
            cs.bound(cs.minhash_bytes(total_nnz, n, k, True, b and cs.B),
                     cs.minhash_ops(total_nnz, n, k, True, b, b > 0)))
        if k == cs.K_PAPER:
            ragged = {f"minhash2u k={k} pack": (
                          lambda g2=g2: kmin.minhash2u_cuda(
                              idx, cnt, g2.a1, g2.a2, s=cs.S, b=cs.B)),
                      f"minhash4u k={k} pack": (
                          lambda g4=g4: kmin.minhash4u_cuda(
                              idx, cnt, g4.a, s=cs.S, b=cs.B))}

    # one launch by CUDA events beside each graph-timed chunk kernel
    for name in ("oph2u k=512", "oph4u k=512", "minhash2u k=500"):
        cases[f"{name} single"] = (cases[name][0], "events", None)

    # -- the change against the parent, bit for bit ----------------------------
    outs = {}
    for tag in ("parent", "change"):
        use(tag)
        outs[tag] = {name: fn() for name, (fn, how, _) in cases.items()
                     if how != "eager" and not name.endswith(" single")}
    same = [name for name in outs["change"] if name not in ragged]
    parts = lambda out: out if isinstance(out, tuple) else (out,)
    for name in same:
        if not all(torch.equal(c, p) for c, p in zip(
                parts(outs["change"][name]), parts(outs["parent"][name]))):
            raise AssertionError(f"{name}: change != parent")
    print(f"[ab] change == parent bit for bit: {', '.join(same)}", flush=True)
    for name, unpacked in ragged.items():
        sig, words = outs["change"][name]
        want = unpacked()
        if not (torch.equal(sig, want)
                and torch.equal(words, pack_codes(want, cs.B))):
            raise AssertionError(f"{name}: change != pack_codes of its codes")
    print(f"[ab] change == pack_codes of its own unpacked codes: "
          f"{', '.join(ragged)}", flush=True)
    del outs
    use("change")
    n_edge = cs.check_minhash4u_edges(torch, dev)
    n_edge2 = cs.check_minhash2u_edges(torch, dev)
    n_oph = cs.check_oph_edges(torch, dev)
    n_odd = cs.check_match_odd_shapes(torch, dev)
    n_sig = sum(cs.check_sigbag_edges(torch, dev).values())
    print(f"[ab] change == plain versions: minhash4u edge chunk ({n_edge} "
          f"cases), minhash2u edge chunk ({n_edge2} cases), oph2u / oph4u "
          f"edge chunk ({n_oph} cases), packed_match odd shapes ({n_odd} "
          f"cases), sigbag edge set ({n_sig} cases, both designs)",
          flush=True)

    # -- timings, in turns ----------------------------------------------------------
    times = collections.defaultdict(list)
    for tag in ("parent", "change", "change", "parent"):
        use(tag)
        for name, (fn, how, _) in cases.items():
            if how == "events":
                ms = cs.median_ms(fn, torch)
            elif how == "graph":
                ms = cs.graph_ms(fn, torch, cs.KERNEL_LOOP)
            else:
                ms = cs.median_ms(lambda: [fn() for _ in range(cs.BLOCK_LOOP)],
                                  torch) / cs.BLOCK_LOOP
            times[(name, tag)].append(ms)
    for name, (_, how, bnd) in cases.items():
        par, chg = times[(name, "parent")], times[(name, "change")]
        line = (f"[ab] {name} ({how}): parent {par[0]:.4f} / {par[1]:.4f} ms, "
                f"change {chg[0]:.4f} / {chg[1]:.4f} ms, change/parent "
                f"{statistics.mean(chg) / statistics.mean(par):.3f}")
        if bnd:
            line += (f"; bound {bnd[0]:.4f} ms ({bnd[1]}): parent "
                     f"{bnd[0] / statistics.mean(par):.0%}, change "
                     f"{bnd[0] / statistics.mean(chg):.0%}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
