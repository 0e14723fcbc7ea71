"""Import hygiene of the PyTorch port, and equality of its own copies of the
numpy-only data modules with the JAX package's.

The port (`mpctsid_tpu_torch/`, `chip_smoke.py`) imports torch and numpy,
never jax, never flax and nothing from `mpctsid_tpu`; only the tests import
both.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mpctsid_tpu.command as j_command
import mpctsid_tpu.config as j_config
import mpctsid_tpu.model.gaits as j_gaits
import mpctsid_tpu.model.solo12 as j_solo12
import mpctsid_tpu.model.tree as j_tree
import mpctsid_tpu.plan.gait as j_plan_gait
import mpctsid_tpu_torch.command as t_command
import mpctsid_tpu_torch.config as t_config
import mpctsid_tpu_torch.model.gaits as t_gaits
import mpctsid_tpu_torch.model.solo12 as t_solo12
import mpctsid_tpu_torch.model.tree as t_tree
import mpctsid_tpu_torch.plan.gait as t_plan_gait

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mpctsid_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|mpctsid_tpu)(\.|\s|$)")

PORT_SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_the_port_has_sources_to_check():
    names = {p.name for p in PORT_SOURCES}
    assert {"admm.py", "kernels.py", "engine.py", "chip_smoke.py",
            "filter.py", "interface.py", "sweep.py", "host.py", "graphs.py",
            "runtime.py", "mesh.py", "entry.py", "bench.py"} <= names
    for source in ("admm_m2.cu", "admm_vpu.cu", "admm_packed.cu",
                   "admm_fused.cu", "admm_mma.cu", "admm_block.cuh"):
        assert (PORT / "qp" / "csrc" / source).exists(), source
    for module in ("__init__.py", "cascade.py", "dynamics.py",
                   "estimator.py", "mpc.py", "planner.py", "qp.py", "sim.py",
                   "wbc.py"):
        assert PORT / "oracle" / module in PORT_SOURCES, module


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_the_jax_package(path):
    bad = [f"{path.name}:{i}: {line.strip()}"
           for i, line in enumerate(path.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, bad


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "  import jax.numpy as jnp",
                 "from mpctsid_tpu.qp import admm", "import mpctsid_tpu",
                 "from flax import serialization", "import flax"):
        assert FORBIDDEN.match(line), line
    for line in ("import mpctsid_tpu_torch", "from mpctsid_tpu_torch.qp import x",
                 "# import jax", "import jaxtyping"):
        assert not FORBIDDEN.match(line), line


def test_importing_every_port_module_loads_no_jax_and_builds_nothing():
    """In a fresh interpreter without a GPU toolchain: every module of the
    port imports, `jax` and `mpctsid_tpu` stay unloaded, and neither the
    extension's library nor its build directory comes into being."""
    code = r"""
import importlib, os, pkgutil, sys, tempfile
build = os.path.join(tempfile.mkdtemp(), "build")
os.environ["MPCTSID_TORCH_BUILD_DIR"] = build
import mpctsid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpctsid_tpu_torch.__path__,
                                               "mpctsid_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 45, names
for n in ("est.filter", "env.interface", "sweep", "host", "utils.graphs",
          "native.runtime", "dist.mesh", "entry", "oracle.cascade",
          "oracle.sim", "oracle.estimator"):
    assert "mpctsid_tpu_torch." + n in names, n
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "flax" or m.startswith("flax.") or m == "msgpack"
          or m == "mpctsid_tpu" or m.startswith("mpctsid_tpu.")]
assert not loaded, loaded
assert "triton" not in sys.modules
from mpctsid_tpu_torch.qp import _build, kernels
assert not kernels._LIBS and not _build._LIBS and not _build.BUILD_SECONDS
assert not os.path.exists(build)
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.get_float32_matmul_precision() == "highest"
print("HYGIENE_OK", len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "HYGIENE_OK" in r.stdout


def test_kernel_on_a_cpu_tensor_does_not_reach_the_build_step(monkeypatch):
    import torch
    from mpctsid_tpu_torch.qp import _build, kernels

    def boom(*a, **k):
        raise AssertionError("load_library was reached for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", boom)
    z = torch.zeros
    out = kernels.admm_iterate_m2(torch.eye(3)[None], z(1, 2, 3), z(1, 3),
                                  z(1, 2), z(1, 2), torch.ones(1, 2), z(1, 3),
                                  z(1, 2), z(1, 2), iters=2)
    assert out[0].shape == (1, 3)
    for fn in (kernels.admm_iterate_vpu, kernels.admm_iterate_vpu_packed,
               kernels.admm_iterate):
        out = fn(torch.eye(3)[None], torch.eye(3)[None], z(1, 2, 3), z(1, 3),
                 z(1, 2), z(1, 2), torch.ones(1, 2), z(1, 3), z(1, 2),
                 z(1, 2), iters=2)
        assert out[0].shape == (1, 3)
    out = kernels.admm_solve_fused(
        torch.eye(3)[None], z(1, 3), torch.ones(1, 2, 3), -torch.ones(1, 2),
        torch.ones(1, 2), z(1, 2), z(1, 3), z(1, 2), iters=4, adapt_rounds=2,
        equilibrate_iters=2, rho0=0.1, sigma=1e-6, alpha=1.6,
        rho_eq_scale=1e3, inf=1e20)
    assert out[0].shape == (1, 3) and out[4].shape == (1,)


def test_build_step_without_a_toolchain_raises(monkeypatch, tmp_path):
    """No nvcc here: asking for the library raises (nothing falls back)."""
    import shutil
    from mpctsid_tpu_torch.qp import _build
    if shutil.which("nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("MPCTSID_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library("admm_m2_probe", ("admm_m2.cu",))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_libraries([("a", ("admm_vpu.cu",), ("admm_block.cuh",)),
                                ("b", ("admm_fused.cu",), ())])
    assert not _build.BUILD_SECONDS.get("a")
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _eq(a, b, path):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for n in fa:
            _eq(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("name", sorted(j_config.PRESETS))
def test_config_presets_equal_field_by_field(name):
    assert sorted(t_config.PRESETS) == sorted(j_config.PRESETS)
    _eq(t_config.PRESETS[name], j_config.PRESETS[name], name)


def test_config_defaults_and_parity_tier_equal():
    for cls in ("MpcConfig", "WbcConfig", "SolverConfig", "CascadeConfig",
                "EngineConfig"):
        _eq(getattr(t_config, cls)(), getattr(j_config, cls)(), cls)
    _eq(t_config.WBC_PARITY_SOLVER, j_config.WBC_PARITY_SOLVER, "parity")
    np.testing.assert_array_equal(t_config.MpcConfig().q_diag,
                                  j_config.MpcConfig().q_diag)


def test_solo12_model_equals_field_and_property():
    _eq(t_solo12.SOLO12, j_solo12.SOLO12, "SOLO12")
    props = [n for n, v in vars(j_solo12.Solo12Model).items()
             if isinstance(v, property)]
    assert len(props) >= 12
    for n in props:
        _eq(getattr(t_solo12.SOLO12, n), getattr(j_solo12.SOLO12, n), n)
    assert t_solo12.JOINT_NAMES == j_solo12.JOINT_NAMES


def test_kinematic_tree_equal():
    _eq(t_tree.build_tree(t_solo12.SOLO12),
        j_tree.build_tree(j_solo12.SOLO12), "tree")
    assert (t_tree.NV, t_tree.N_BODIES) == (j_tree.NV, j_tree.N_BODIES)


def test_gait_tables_equal():
    assert t_gaits.GAIT_IDS == j_gaits.GAIT_IDS
    assert t_gaits.GAIT_PERIOD == j_gaits.GAIT_PERIOD
    np.testing.assert_array_equal(t_gaits.gait_tables(), j_gaits.gait_tables())
    for name in j_gaits.GAITS:
        np.testing.assert_array_equal(t_gaits.GAITS[name].table,
                                      j_gaits.GAITS[name].table)
    for n in ("_BACK_NP", "_FWD_NP", "_DUR_NP", "_STANCE_STEPS_NP", "TABLES"):
        np.testing.assert_array_equal(getattr(t_plan_gait, n),
                                      getattr(j_plan_gait, n), err_msg=n)


def test_command_profiles_equal():
    np.testing.assert_array_equal(t_command.constant(5, 0.3, 0.1, -0.2),
                                  j_command.constant(5, 0.3, 0.1, -0.2))
    np.testing.assert_array_equal(t_command.ramp(9, (0.3, 0.0, 0.1), 3),
                                  j_command.ramp(9, (0.3, 0.0, 0.1), 3))
    np.testing.assert_array_equal(t_command.weave(12), j_command.weave(12))
    spec = [(0.1, (0.1, 0.0, 0.0)), (0.06, (0.3, 0.0, 0.2))]
    np.testing.assert_array_equal(t_command.segments(spec),
                                  j_command.segments(spec))
