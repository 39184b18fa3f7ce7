"""The port stands alone: importing ``repro_torch`` and every module in it
loads neither JAX nor any module of the JAX package ``repro``, and builds
no kernel."""
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    from repro_torch.core.registry import REGISTRY
    assert len(REGISTRY.domains()) == 12
    from repro_torch.kernels.domain_map import kernel
    assert not kernel._libs, "importing built a kernel"
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    print(json.dumps({"modules": names, "bad": bad}))
""")


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["bad"] == []
    assert "repro_torch.serving.evaluate" in seen["modules"]
    assert "repro_torch.kernels.domain_map.kernel" in seen["modules"]
