"""Spans inside ``SignatureEngine`` (``repro_torch.kernels.engine``) and
the tracer's clock (``repro_torch.obs.trace``), on the ``torch`` backend.

  * Each call records ``sig.engine`` with its children ``sig.plan``,
    ``sig.counts``, ``sig.kernel`` and ``sig.epilogue`` (the last only
    where plain PyTorch works after the kernel), linked by parent ids, with
    the launch shape's source, the pack's place and (OPH) the densifier in
    the args; the permutation runner records ``sig.engine`` and
    ``sig.plan`` only.
  * The OPH epilogue records ``sig.densify`` and ``sig.pack`` under
    ``sig.epilogue``: both when densified and packed, ``sig.densify``
    alone unpacked, ``sig.pack`` alone where the kernel emitted sentinel
    codes; a minhash epilogue records neither.
  * The spans record while the tracer is enabled or a ``torch.profiler``
    runs; with neither, a call opens no span and no profiler range.  They
    enter the profiler as ranges only under ``device_annotations=True``.
  * Outputs are bit-identical traced and untraced.
  * The export names its clock, ``time.perf_counter``, and its epoch.
"""

import contextlib
import time

import pytest
import torch

from repro_torch.core.hashing import Hash2U, Hash4U, PermutationFamily
from repro_torch.core.oph import OPH
from repro_torch.data.sparse import SparseBatch
from repro_torch.kernels import SignatureEngine, TuningTable
from repro_torch.obs import trace as tt

S, N, NNZ, D = 16, 24, 40, 1 << 10
CHILDREN = ("sig.plan", "sig.counts", "sig.kernel", "sig.epilogue")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tracer():
    """A fresh process-wide tracer, disabled, put back afterwards."""
    mine = tt.Tracer()
    prev = tt.set_tracer(mine)
    try:
        yield mine
    finally:
        tt.set_tracer(prev)


def _batch(seed=3, n=N, nnz=NNZ):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, D, (n, nnz), generator=g, dtype=torch.int32)
    mask = torch.rand(n, nnz, generator=g) < 0.7
    mask[:, 0] = True
    return SparseBatch(idx, mask)


def _family(kind, k, seed=5):
    g = torch.Generator().manual_seed(seed)
    if kind == "2u":
        return Hash2U.create(k, S, generator=g, device="cpu")
    if kind == "4u":
        return Hash4U.create(k, S, generator=g, device="cpu")
    if kind == "perm":
        return OPH(PermutationFamily.create(1, D, generator=g,
                                            device="cpu"), k=k)
    return OPH.create(k, S, family=kind.split("-")[1],
                      densify=kind.split("-")[2], generator=g, device="cpu")


# (family, k, b, packed) -> the kernel's scheme, the children recorded
# and the pack's place; 128 threads by default: the minhash kernels pack
# any k whose code width divides 32 (k = 100 and the paper's 500 leave a
# ragged last warp), and a 3-bit code packs after the kernel
KERNEL = ("sig.plan", "sig.counts", "sig.kernel")
CASES = {
    "2u-fused": (("2u", 128, 8, True), "minhash2u", KERNEL, "kernel"),
    "2u-ragged": (("2u", 100, 8, True), "minhash2u", KERNEL, "kernel"),
    "2u-k500": (("2u", 500, 8, True), "minhash2u", KERNEL, "kernel"),
    "2u-unfused": (("2u", 100, 3, True), "minhash2u", CHILDREN, "epilogue"),
    "2u-raw": (("2u", 100, 0, False), "minhash2u", KERNEL, "none"),
    "4u-fused": (("4u", 128, 8, True), "minhash4u", KERNEL, "kernel"),
    "4u-ragged": (("4u", 100, 8, True), "minhash4u", KERNEL, "kernel"),
    "4u-k500": (("4u", 500, 8, True), "minhash4u", KERNEL, "kernel"),
    "4u-unfused": (("4u", 100, 3, True), "minhash4u", CHILDREN, "epilogue"),
    "oph-2u-rotation": (("oph-2u-rotation", 64, 8, True), "oph2u", CHILDREN,
                        "epilogue"),
    "oph-4u-sentinel": (("oph-4u-sentinel", 64, 4, True), "oph4u", CHILDREN,
                        "epilogue"),
    "oph-2u-raw": (("oph-2u-rotation", 64, 0, False), "oph2u", CHILDREN,
                   "none"),
    "oph-2u-rotation-k512": (("oph-2u-rotation", 512, 8, True), "oph2u",
                             CHILDREN, "epilogue"),
    "oph-2u-sentinel-raw": (("oph-2u-sentinel", 64, 4, False), "oph2u",
                            CHILDREN, "none"),
    "oph-4u-optimal": (("oph-4u-optimal", 64, 8, True), "oph4u", CHILDREN,
                       "epilogue"),
    "oph-2u-fast": (("oph-2u-fast", 64, 2, False), "oph2u", CHILDREN,
                    "none"),
    "perm": (("perm", 16, 8, True), "ophperm", ("sig.plan",), "epilogue"),
}
# the OPH epilogue's children, by case (none in every other epilogue): the
# densifier and b-bit mask, then the pack; the coded sentinel path (packed
# sentinel) packs the kernel's codes alone
EPILOGUE_KIDS = {
    "oph-2u-rotation": ("sig.densify", "sig.pack"),
    "oph-2u-rotation-k512": ("sig.densify", "sig.pack"),
    "oph-4u-optimal": ("sig.densify", "sig.pack"),
    "oph-4u-sentinel": ("sig.pack",),
    "oph-2u-raw": ("sig.densify",),
    "oph-2u-sentinel-raw": ("sig.densify",),
    "oph-2u-fast": ("sig.densify",),
}


def _call(case, batch=None, **kw):
    (kind, k, b, packed), _, _, _ = CASES[case]
    eng = SignatureEngine(_family(kind, k), b=b, packed=packed, **kw)
    out = eng(batch if batch is not None else _batch())
    return out.data if packed else out


def _densifier(case):
    """The ``densify`` arg ``sig.engine`` records (None: minhash)."""
    kind = CASES[case][0][0]
    return "rotation" if kind == "perm" else (
        kind.split("-")[2] if kind.startswith("oph-") else None)


def _tree(events):
    """{engine span id: (engine event, [child events in order])}; each
    event's own children, in order, under its ``"kids"`` (a grandchild
    nests under its child)."""
    by_id = {e["args"]["span_id"]: dict(e, kids=[]) for e in events}
    engines = {}
    for e in sorted(by_id.values(), key=lambda e: e["ts"]):
        if e["name"] == "sig.engine":
            engines[e["args"]["span_id"]] = (e, e["kids"])
        elif e["args"]["parent_id"] in by_id:
            by_id[e["args"]["parent_id"]]["kids"].append(e)
    return engines


def _in_sequence(parent, kids):
    """``kids`` lie inside ``parent``, one after another."""
    t0, t1 = parent["ts"], parent["ts"] + parent["dur"]
    ends = [t0] + [e["ts"] + e["dur"] for e in kids]
    return all(prev_end <= e["ts"] and e["ts"] + e["dur"] <= t1
               for prev_end, e in zip(ends, kids))


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree_and_args(tracer, case):
    (kind, k, b, packed), scheme, children, pack = CASES[case]
    tracer.enabled = True
    _call(case)
    tree = _tree(tracer.events())
    assert len(tree) == 1
    (top, kids), = tree.values()
    assert top["args"]["parent_id"] == 0
    assert [e["name"] for e in kids] == list(children)
    assert all(e["args"]["parent_id"] == top["args"]["span_id"]
               for e in kids)
    args = {key: top["args"][key] for key in
            ("rows", "nnz", "k", "b", "shape", "pack")}
    assert args == {"rows": N, "nnz": NNZ, "k": k, "b": b,
                    "shape": "default", "pack": pack}
    assert top["args"]["scheme"] == scheme
    assert top["args"]["threads"] == {"minhash": 128, "oph2u": 256,
                                      "oph4u": 256}.get(scheme[:7])
    assert top["args"].get("densify") == _densifier(case)
    # children lie inside their parent, one after another; only the OPH
    # epilogue has children of its own
    assert _in_sequence(top, kids)
    for e in kids:
        want = EPILOGUE_KIDS.get(case, ()) if e["name"] == "sig.epilogue" \
            else ()
        assert [g["name"] for g in e["kids"]] == list(want)
        assert all(g["args"]["parent_id"] == e["args"]["span_id"]
                   for g in e["kids"])
        assert _in_sequence(e, e["kids"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_and_pack_spans_only_in_the_oph_epilogue(tracer, case):
    tracer.enabled = True
    _call(case)
    names = [e["name"] for e in tracer.events()]
    want = list(EPILOGUE_KIDS.get(case, ()))
    assert [n for n in names if n in ("sig.densify", "sig.pack")] == want


def test_oph_epilogue_called_alone_records_nothing(tracer):
    """Outside the engine (``kernels.ops``, the smoke script) the
    epilogue takes no span and records none, tracer on or off."""
    from repro_torch.kernels.engine import oph_epilogue
    tracer.enabled = True
    raw = torch.full((3, 64), -1, dtype=torch.int32)
    raw[:, 5] = 7
    words = oph_epilogue(raw, k=64, s=S, bin_bits=6, densify="rotation",
                         b=8, packed=True)
    assert words.shape == (3, 16) and tracer.events() == []


@pytest.mark.parametrize("kind", ["2u", "4u"])
def test_shape_arg_names_where_the_launch_shape_came_from(tracer, kind):
    tracer.enabled = True
    fam, batch = _family(kind, 100), _batch()
    table = TuningTable()
    table.record("torch", f"minhash{kind}", 100, NNZ, {"threads": 64})
    SignatureEngine(fam, b=8, packed=True)(batch)
    SignatureEngine(fam, b=8, packed=True, tuning=table)(batch)
    SignatureEngine(fam, b=8, packed=True, blocks={"threads": 96})(batch)
    got = [(e["args"]["shape"], e["args"]["threads"]) for e in
           sorted(tracer.events(), key=lambda e: e["ts"])
           if e["name"] == "sig.engine"]
    assert got == [("default", 128), ("table", 64), ("explicit", 96)]


def test_pack_moves_into_the_kernel_with_the_group(tracer):
    """k = 96 packs in a 128-thread 4U kernel (a ragged group) as in a
    32-thread one (whole groups); a 3-bit code packs after the kernel
    whatever the launch shape."""
    tracer.enabled = True
    fam, batch = _family("4u", 96), _batch()
    a = SignatureEngine(fam, b=8, packed=True)(batch)
    b = SignatureEngine(fam, b=8, packed=True, blocks={"threads": 32})(batch)
    c = SignatureEngine(fam, b=3, packed=True, blocks={"threads": 32})(batch)
    assert torch.equal(a.data, b.data)
    assert torch.equal(c.unpack(), a.unpack() & 7)
    tree = sorted(_tree(tracer.events()).values(), key=lambda t: t[0]["ts"])
    assert [t[0]["args"]["pack"] for t in tree] == ["kernel", "kernel",
                                                    "epilogue"]
    assert ["sig.epilogue" in [e["name"] for e in kids] for _, kids in tree] \
        == [False, False, True]


def test_nested_in_a_callers_span(tracer):
    tracer.enabled = True
    with tracer.span("caller") as outer:
        _call("2u-unfused")
    top, = [e for e in tracer.events() if e["name"] == "sig.engine"]
    assert top["args"]["parent_id"] == outer.span_id


@contextlib.contextmanager
def _no_profiler_ranges(monkeypatch):
    """Fail on any ``record_function`` opened while the block runs."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    yield
    monkeypatch.undo()


@pytest.mark.parametrize("case", ["2u-unfused", "4u-fused",
                                  "oph-2u-rotation", "perm"])
def test_off_records_nothing_and_opens_no_range(tracer, monkeypatch, case):
    tracer.device_annotations = True        # still off: nothing records
    opened = []
    monkeypatch.setattr(tt.Tracer, "_open",
                        lambda self, *a: opened.append(a))
    with _no_profiler_ranges(monkeypatch):
        _call(case)
    assert tracer.events() == [] and opened == []
    assert not tracer.recording()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("case", ["2u-unfused", "4u-fused",
                                  "oph-4u-sentinel"])
def test_profiler_records_spans_but_no_ranges(tracer, case):
    assert not tracer.enabled
    names = _profiled(lambda: _call(case))
    recorded = [e["name"] for e in tracer.events()]
    assert "sig.engine" in recorded and "sig.kernel" in recorded
    assert not {n for n in names if n.startswith("sig.")}
    assert not tracer.recording()                   # the profiler is gone
    tracer.reset()
    _call(case)
    assert tracer.events() == []


def test_device_annotations_make_the_spans_profiler_ranges(tracer):
    tracer.device_annotations = True
    names = _profiled(lambda: _call("2u-unfused"))
    assert set(CHILDREN) | {"sig.engine"} <= names
    assert {e["name"] for e in tracer.events()} == \
        set(CHILDREN) | {"sig.engine"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_bit_identical_traced_and_untraced(tracer, case):
    batch = _batch(seed=11)
    plain = _call(case, batch)
    tracer.enabled = True
    traced = _call(case, batch)
    tracer.enabled = False
    profiled = []
    _profiled(lambda: profiled.append(_call(case, batch)))
    assert tracer.events()
    assert torch.equal(plain, traced) and torch.equal(plain, profiled[0])


def test_export_names_its_clock_and_epoch(tracer):
    tracer.reset(enabled=True)
    before = time.perf_counter()
    _call("2u-fused")
    after = time.perf_counter()
    doc = tracer.to_json()
    assert doc["otherData"]["clock"] == "perf_counter" == tt.CLOCK
    epoch = doc["otherData"]["epoch_s"]
    assert epoch <= before
    for e in doc["traceEvents"]:
        t0 = epoch + e["ts"] * 1e-6
        assert before - 1e-6 <= t0 and t0 + e["dur"] * 1e-6 <= after + 1e-6


def test_recording_follows_the_profiler_on_this_thread(tracer):
    assert not tracer.recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracer.recording()
    assert not tracer.recording()
    tracer.enabled = True
    assert tracer.recording()
