"""Port parity for the mesh and the sharding rules (``repro_torch.launch.mesh``,
``repro_torch.sharding.rules``) against the JAX package:

  * ``_resolve`` / ``spec`` / ``_axis_size`` equal the reference's, specs
    compared as tuples, over ("data", "model") (2, 4) and ("pod", "data",
    "model") (2, 2, 2): logical names, tuples, "all" and absent axes;
  * ``data_axis_devices`` and ``place_shards`` pick the reference's
    positions (round-robin, tail-stable) on 1-D, 2-D and 3-D meshes;
  * ``make_debug_mesh`` validates as the reference does;
    ``make_production_mesh`` (a process mesh since training on a mesh)
    refuses a world that is not 256 / 512 ranks; without a mesh
    ``constrain`` returns ``x`` and ``named_sharding`` None, as the
    reference's do.

The JAX meshes are built from the forced host devices; the port's from
labelled CPU positions (``torch.device("cpu", i)``: the rules never make
a tensor, so the labels only tell positions apart).
"""

import threading

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.sharding import rules as jrules
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.sharding import rules

MESHES = {
    "2d": (("data", "model"), (2, 4)),
    "3d": (("pod", "data", "model"), (2, 2, 2)),
}

AXES = [
    (), (None,), ("batch",), ("data",), ("model",), ("pod",), ("all",),
    ("batch", None, "model"), (("data", "model"),), (("batch", "model"),),
    (("all",),), (("pod", "model"),), (("model", "model"),), (("nope",),),
    ("nope",), ("batch", "batch"), (("batch", "all"),), ((),),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port test module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labels(n):
    return [torch.device("cpu", i) for i in range(n)]


def _meshes(name, host_devices):
    axes, shape = MESHES[name]
    n = int(np.prod(shape))
    jm = JMesh(np.array(host_devices[:n]).reshape(shape), axes)
    tm = make_debug_mesh(n, axes=axes, shape=shape, devices=_labels(n))
    return jm, tm


@pytest.mark.parametrize("axes", AXES, ids=repr)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_resolve_and_spec_match_reference(host_devices, name, axes):
    jm, tm = _meshes(name, host_devices)
    with jrules.set_mesh(jm), rules.set_mesh(tm):
        want, got = jrules.spec(*axes), rules.spec(*axes)
        assert isinstance(got, rules.PartitionSpec)
        assert tuple(got) == tuple(want)
        for a in axes:
            r = rules._resolve(a, tm)
            assert r == jrules._resolve(a, jm)
            assert rules._axis_size(tm, r) == jrules._axis_size(jm, r)


def test_spec_without_a_mesh_is_empty_and_the_mesh_is_per_thread():
    assert tuple(rules.spec("batch", "model")) == \
        tuple(jrules.spec("batch", "model")) == ()
    assert repr(rules.PartitionSpec("data", None)) == \
        "PartitionSpec('data', None)"
    tm = make_debug_mesh(2, axes=("data",), devices=_labels(2))
    seen = []
    with rules.set_mesh(tm):
        assert rules.current_mesh() is tm
        t = threading.Thread(target=lambda: seen.append(rules.current_mesh()))
        t.start()
        t.join(timeout=10)
        assert tuple(rules.spec("batch")) == ("data",)
    assert not t.is_alive() and seen == [None]
    assert rules.current_mesh() is None


def _ids(devs, pool):
    return [pool.index(d) for d in devs]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_data_axis_devices_match_reference(host_devices, name):
    jm, tm = _meshes(name, host_devices)
    labels = list(tm.devices.reshape(-1))
    assert _ids(rules.data_axis_devices(tm), labels) == \
        _ids(jrules.data_axis_devices(jm), list(host_devices))
    assert _ids(rules.data_axis_devices(tm, "model"), labels) == \
        _ids(jrules.data_axis_devices(jm, "model"), list(host_devices))
    with pytest.raises(ValueError, match="no 'nope' axis"):
        rules.data_axis_devices(tm, "nope")


@pytest.mark.parametrize("n_pos", [1, 3, 4, 8])
def test_place_shards_round_robin_and_tail_stable(host_devices, n_pos):
    jm = JMesh(np.array(host_devices[:n_pos]), ("data",))
    tm = make_debug_mesh(n_pos, axes=("data",), devices=_labels(n_pos))
    labels = list(tm.devices)
    for n_shards in (1, 2, 5, 11):
        got = rules.place_shards(n_shards, tm)
        want = jrules.place_shards(n_shards, jm)
        assert _ids(got, labels) == _ids(want, list(host_devices)) == \
            [s % n_pos for s in range(n_shards)]
        assert rules.place_shards(n_shards + 3, tm)[:n_shards] == got
    with pytest.raises(ValueError, match="n_shards"):
        rules.place_shards(0, tm)
    assert rules.place_shards(3) is None
    with rules.set_mesh(tm):                    # the current mesh
        assert rules.place_shards(2) == rules.place_shards(2, tm)


def test_positions_may_share_a_device():
    cpu = torch.device("cpu")
    tm = make_debug_mesh(8, axes=("data",), devices=[cpu] * 8)
    assert tm.shape == {"data": 8} and tm.size == 8
    assert rules.data_axis_devices(tm) == (cpu,) * 8
    assert rules.place_shards(3, tm) == (cpu,) * 3


def test_make_debug_mesh_validates():
    cpu = torch.device("cpu")
    m = make_debug_mesh(4, devices=[cpu] * 4)          # model-major default
    assert m.axis_names == ("data", "model") and m.shape == \
        {"data": 1, "model": 4}
    m = make_debug_mesh(4, axes=("pod", "data", "model"), shape=(1, 2, 2),
                        devices=[cpu] * 6)
    assert m.devices.shape == (1, 2, 2)
    with pytest.raises(ValueError, match="n_devices"):
        make_debug_mesh(0, devices=[cpu])
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_debug_mesh(4, axes=("data", "model"), shape=(2, 3),
                        devices=[cpu] * 8)
    with pytest.raises(ValueError, match="have 2"):
        make_debug_mesh(4, axes=("data",), devices=[cpu] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_debug_mesh(1, axes=("data",))       # no CUDA device here
        with pytest.raises(ValueError, match="needs 256 devices"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 devices"):
            make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([cpu, cpu], dtype=object), ("data", "model"))
    one = np.empty((1, 1), dtype=object)
    one[0, 0] = cpu
    with pytest.raises(ValueError, match="repeated"):
        Mesh(one, ("data", "data"))


def test_production_mesh_shapes_need_their_devices(monkeypatch):
    """The reference's (16, 16) and (2, 16, 16) shapes are process meshes
    (one rank a card), refused in a world of another size (the world of
    ``torchrun``'s environment, faked here: 100 ranks); the retrieval
    mesh still lays 8 positions on the CUDA devices (their count faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 100)
    monkeypatch.setenv("WORLD_SIZE", "100")
    with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 devices "
                                         r"\(one rank each\), the world "
                                         r"has 100"):
        make_production_mesh()
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) needs 512"):
        make_production_mesh(multi_pod=True)
    m = make_debug_mesh(8, axes=("pod", "data", "model"), shape=(2, 2, 2))
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert list(m.devices.reshape(-1)) == \
        [torch.device("cuda", i) for i in range(8)]
    assert "pod=2, data=2, model=2" in repr(m)


def test_layout_binding_is_not_ported():
    """Without a mesh ``constrain`` returns ``x`` itself and
    ``named_sharding`` None, as the reference's do
    (``tests/test_sharding_moe.py``); under the retrieval mesh, whose
    positions are not ranks, ``constrain`` binds nothing either and
    ``named_sharding`` names the reference's spec."""
    x = torch.zeros(4)
    assert rules.constrain(x, "batch") is x
    assert rules.named_sharding("batch") is None
    y = x.numpy()
    assert jrules.constrain(y, "batch") is y
    m = make_debug_mesh(4, axes=("data", "model"), shape=(2, 2),
                        devices=_labels(4))
    with rules.set_mesh(m):
        assert rules.constrain(x, "batch") is x
        assert tuple(rules.named_sharding("batch", None).spec) == (
            "data", None)
