"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py`` or ``kernel_ab.py``) imports JAX or the JAX package; entry points refuse to
run on the CPU unless asked; CUDA wrappers refuse CPU tensors."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
# the batch-learning, recsys, LM, GNN, retrieval-mesh, mesh-training and
# dry-run slices' modules,
# which the walk must have reached
required = ["repro_torch." + m for m in (
    "core.minhash", "core.vw", "core.lsh", "optim", "optim.base",
    "optim.schedules", "optim.optimizers", "train.trainer",
    "train.checkpoint", "train.fault", "kernels.ops", "tree",
    "launch.train", "configs.autoint", "configs.din", "configs.mind",
    "models.attention", "models.transformer", "models.moe", "models.layers",
    "configs.deepseek_7b", "configs.yi_34b", "configs.mistral_large_123b",
    "configs.llama4_scout", "configs.deepseek_v3_671b", "models.gnn",
    "configs.gatedgcn", "roofline.analysis", "roofline.hardware",
    "launch.mesh", "sharding.rules", "sharding.params", "sharding.spmd",
    "optim.compression", "train.elastic", "launch.dryrun",
    "roofline.analytic", "roofline.report")]
for name in names + required:
    importlib.import_module(name)
import chip_smoke, kernel_ab
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
missing = sorted(set(required) - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """Alone in a directory (or with no CUDA device) the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    from repro_torch.data.sparse import from_lists
    from repro_torch.device import resolve_device
    from repro_torch.train.online import OnlineTrainer, make_family

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_family("oph", 64, 16)
    with pytest.raises(RuntimeError):
        OnlineTrainer(k=64, b=8)
    with pytest.raises(RuntimeError):
        from_lists([[1, 2, 3]])
    assert resolve_device("cpu").type == "cpu"
    fam = make_family("oph", 64, 16, device="cpu")
    assert fam.device.type == "cpu"


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels import oph as koph

    idx = torch.zeros((4, 128), dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        koph.oph2u_cuda(idx, counts, one, one, s=16, bin_bits=6)
    with pytest.raises(ValueError, match="CUDA"):
        koph.oph4u_cuda(idx, counts, torch.ones((4, 1), dtype=torch.int32),
                        s=16, bin_bits=6)
    with pytest.raises(ValueError, match="CUDA"):
        kmin.minhash2u_cuda(idx, counts, one.repeat(8), one.repeat(8), s=16)
    with pytest.raises(ValueError, match="CUDA"):
        kmin.minhash4u_cuda(idx, counts, torch.ones((4, 8), dtype=torch.int32),
                            s=16)
    assert koph.oph2u_cuda.launches == 0 and kmin.minhash2u_cuda.launches == 0
    # the dispatching wrapper takes the plain version only for CPU tensors
    out = koph.oph2u(idx, counts, one, one, s=16, bin_bits=6)
    assert out.shape == (4, 64) and koph.oph2u_cuda.launches == 0
