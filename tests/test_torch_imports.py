"""The port stands alone: importing ``repro_torch``, every module in it and
``chip_smoke.py`` loads neither JAX nor any module of the JAX package
``repro``, and builds no kernel."""
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = textwrap.dedent("""
    import importlib, importlib.util, json, pkgutil, sys
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    from repro_torch.core.registry import REGISTRY
    assert len(REGISTRY.domains()) == 12
    from repro_torch.kernels import build
    assert not build.LOADED, "importing built a kernel"
    from repro_torch.kernels.tri_attn import kernel as attn_kernel
    from repro_torch.kernels.wkv import kernel as wkv_kernel
    assert set(build.LIBRARIES) == {"map_kernel", "membership_kernel",
                                    "tri_attn", "wkv"}
    assert attn_kernel.ATTN_LAUNCHES == 0
    assert wkv_kernel.WKV_LAUNCHES == 0
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    assert not build.LOADED, "importing built a kernel"
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    print(json.dumps({"modules": names, "bad": bad}))
""")


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    probe = PROBE.replace(
        "CHIP_SMOKE", repr(os.path.abspath(os.path.join(ROOT,
                                                        "chip_smoke.py"))))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["bad"] == []
    assert "repro_torch.serving.evaluate" in seen["modules"]
    assert "repro_torch.kernels.domain_map.kernel" in seen["modules"]
    for name in ("repro_torch.models.transformer",
                 "repro_torch.kernels.tri_attn.kernel",
                 "repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.train.train_step", "repro_torch.configs.yi_6b",
                 "repro_torch.kernels.wkv.kernel",
                 "repro_torch.kernels.wkv.ops", "repro_torch.models.rwkv6",
                 "repro_torch.models.moe", "repro_torch.models.mamba2"):
        assert name in seen["modules"]
    # the derive path
    for name in ("repro_torch.core.paper_tables",
                 "repro_torch.core.synthesis", "repro_torch.core.complexity",
                 "repro_torch.core.validate", "repro_torch.core.maps.variants",
                 "repro_torch.core.store", "repro_torch.core.artifact",
                 "repro_torch.core.energy", "repro_torch.core.backends",
                 "repro_torch.core.pipeline", "repro_torch.obs",
                 "repro_torch.obs.metrics", "repro_torch.obs.trace",
                 "repro_torch.launch.analytic", "repro_torch.launch.dryrun"):
        assert name in seen["modules"]
    # evaluation serving
    for name in ("repro_torch.serving.batching",
                 "repro_torch.serving.map_service",
                 "repro_torch.serving.router", "repro_torch.serving.cluster",
                 "repro_torch.serving.http", "repro_torch.serving.aio",
                 "repro_torch.serving.client", "repro_torch.serving.wire"):
        assert name in seen["modules"]
    # continuous batching for the engine backend (queue 1 item 7); the
    # probe above holds it, like every module, free of jax and repro
    assert "repro_torch.serving.async_engine" in seen["modules"]
    # single-device training (queue 1 item 9a)
    for name in ("repro_torch.train.optimizer", "repro_torch.train.data",
                 "repro_torch.train.checkpoint",
                 "repro_torch.train.fault_tolerance",
                 "repro_torch.launch.train"):
        assert name in seen["modules"]
    # launch and analysis tooling (queue 1 item 10)
    for name in ("repro_torch.configs.shapes", "repro_torch.launch.specs",
                 "repro_torch.launch.mesh", "repro_torch.launch.roofline",
                 "repro_torch.launch.hlo_analysis"):
        assert name in seen["modules"]
