"""The PyTorch port stands alone: it imports torch and never jax."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    # a fresh interpreter: this process already imported jax (conftest)
    code = ("import sys, asset_asrl_torch as ast; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m.startswith('asset_asrl_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


WALK = """
import importlib, pkgutil, sys
import asset_asrl_torch
names = ["asset_asrl_torch"] + [m.name for m in pkgutil.walk_packages(
    asset_asrl_torch.__path__, "asset_asrl_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("jaxlib") or m.startswith("asset_asrl_tpu")]
print(len(names), sorted(names))
print(bad)
sys.exit(1 if bad else 0)
"""

NEW_MODULES = ["asset_asrl_torch.Integrators", "asset_asrl_torch.Integrators.rk",
               "asset_asrl_torch.OptimalControl.mesh",
               "asset_asrl_torch.OptimalControl.interp_table",
               "asset_asrl_torch.OptimalControl.fdtable",
               "asset_asrl_torch.Solvers.fused",
               "asset_asrl_torch.Solvers.optprob",
               "asset_asrl_torch.Solvers.jet", "asset_asrl_torch.parallel",
               "asset_asrl_torch.VectorFunctions.interp",
               "asset_asrl_torch.VectorFunctions.rootfinder",
               "asset_asrl_torch.VectorFunctions.pyfunc",
               "asset_asrl_torch.VectorFunctions.Extensions.DerivChecker",
               "asset_asrl_torch.Astro.J2", "asset_asrl_torch.Astro.Frames",
               "asset_asrl_torch.Astro.AstroModels",
               "asset_asrl_torch.Astro.AstroConstraints",
               "asset_asrl_torch.Astro.Extensions.EPPRFrame",
               "asset_asrl_torch.Astro.Extensions.NBodyFrame",
               "asset_asrl_torch.Astro.Extensions.frame_kinematics",
               "asset_asrl_torch.Utils", "asset_asrl_torch.distributed",
               "asset_asrl_torch.Solvers.kkt_sharded",
               "asset_asrl_torch.tools.mp_worker",
               "asset_asrl_torch.examples"]
# the example suite: a copy of every script of the JAX package's
# `examples/` (importing one builds its tables and classes, and solves
# nothing)
NEW_MODULES += ["asset_asrl_torch.examples." + ".".join(
    p.relative_to(ROOT / "examples").with_suffix("").parts)
    for p in sorted((ROOT / "examples").rglob("*.py"))]


def test_every_module_imports_without_jax():
    """Every module of the port, imported one by one in a fresh
    interpreter, leaves jax and the JAX package out of sys.modules."""
    r = subprocess.run([sys.executable, "-c", WALK], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    walked = r.stdout.splitlines()[0]
    for name in NEW_MODULES:
        assert f"'{name}'" in walked, name


def test_astro_extensions_import_without_jax():
    """`import asset_asrl_torch.Astro.Extensions` alone, in a fresh
    interpreter, leaves jax out; the port's Astro and VectorFunctions
    namespaces export every name the JAX package's do."""
    code = ("import sys, asset_asrl_torch.Astro.Extensions as E; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m.startswith('asset_asrl_tpu')]; "
            "print(bad, E.EPPRFrame, E.NBodyFrame); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    import importlib
    import asset_asrl_torch as tast
    for sub in ("Astro", "Astro.Extensions", "VectorFunctions"):
        jmod = importlib.import_module("asset_asrl_tpu." + sub)
        tmod = importlib.import_module("asset_asrl_torch." + sub)
        names = [n for n in vars(jmod) if not n.startswith("_")]
        missing = [n for n in names if not hasattr(tmod, n)]
        assert not missing, (sub, missing)
    for name in ("InterpTable1D", "InterpTable2D", "InterpTable3D",
                 "InterpTable4D", "ScalarRootFinder", "RootFinder",
                 "PyVectorFunction", "PyScalarFunction"):
        assert hasattr(tast.VectorFunctions, name), name


def test_chip_smoke_imports_without_jax():
    code = ("import sys, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m.startswith('asset_asrl_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|asset_asrl_tpu)\b|"
                     r"from\s+(jax|jaxlib|asset_asrl_tpu)\b)", re.M)
    files = sorted((ROOT / "asset_asrl_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 1
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
