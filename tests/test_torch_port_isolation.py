"""The port stands alone: ``znicz_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` (nor ``orbax``) nor any ``znicz_tpu`` module, and importing the
kernel modules needs no CUDA toolkit (kernels build at their first CUDA
call).  Also the drift check for the modules the port keeps as copies
of the reference: the same code, imports renamed to the port."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, os, pkgutil, sys, importlib
sys.path.insert(0, os.getcwd())
import znicz_tpu_torch
mods = ["znicz_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(znicz_tpu_torch.__path__,
                                          "znicz_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "orbax"))
             or m == "znicz_tpu" or m.startswith("znicz_tpu."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    # no toolkit on PATH and no CUDA_HOME: imports must not reach nvcc
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["bad"] == []
    assert "znicz_tpu_torch.kernels.decode" in doc["modules"]
    assert "znicz_tpu_torch.serve.server" in doc["modules"]
    assert "znicz_tpu_torch.kernels.flash_attention" in doc["modules"]
    assert "znicz_tpu_torch.parallel.tp" in doc["modules"]
    for name in ("kernels.gemm", "kernels.optim", "parallel.step",
                 "models.mnist_fc", "core.workflow", "units.gd",
                 "kernels.conv", "ops.conv", "ops.pooling", "ops.lrn",
                 "ops.dropout", "units.conv", "units.gd_conv",
                 "units.pooling", "units.gd_pooling", "units.normalization",
                 "units.dropout", "standard_workflow", "models.alexnet",
                 "kernels.counter_rng", "kernels.kohonen", "kernels.pooling",
                 "kernels.lrn", "kernels.dropout", "ops.kohonen",
                 "units.kohonen", "models.kohonen", "models.mnist_conv",
                 "models.cifar_conv", "utils.kernel_hw", "native",
                 "pipeline", "pipeline.prefetcher", "loader.mnist",
                 "loader.pickles", "loader.normalization",
                 "resilience.retry", "snapshotter", "launcher", "__main__",
                 "observe.flight", "observe.watchtower",
                 "resilience.supervisor", "loader.image",
                 "units.mean_disp_normalizer", "models.image_ae",
                 "models.yale_faces", "loader.text", "loader.sequence",
                 "parallel.moe", "parallel.graphs", "units.lm",
                 "models.char_lm", "parallel.mesh", "parallel.zero",
                 "parallel.qcomm", "parallel.ring_attention",
                 "parallel.pipeline", "parallel.checkpoint",
                 "serve.engine", "serve.batcher",
                 "native.infer", "utils.export", "units.activation",
                 "units.cutter", "units.resizable_all2all", "units.rbm",
                 "units.weights_zerofilling", "units.nn_rollback",
                 "units.lr_adjust", "units.diversity", "units.image_saver",
                 "units.nn_plotting", "plotting", "models.wine",
                 "models.approximator", "models.spam", "models.tv_channels",
                 "models.rbm", "loader.interactive", "loader.restful",
                 "utils.flops", "utils.profiling", "observe.anatomy",
                 "observe.federation", "resilience.health",
                 "resilience.elastic", "models.elastic_drill",
                 "fleet", "fleet.workers", "fleet.router", "fleet.rollout",
                 "fleet.autoscale", "fleet.cli", "learn", "learn.spool",
                 "learn.publish", "learn.bridge", "learn.trainer_workflow",
                 "learn.cli", "loader.spool"):
        assert f"znicz_tpu_torch.{name}" in doc["modules"]


def test_port_sources_never_name_jax_or_the_reference_in_imports():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|znicz_tpu)\b"
                         r"(?!_torch)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO,
                                                  "znicz_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    offenders = [p for p in paths if pattern.search(open(p).read())]
    assert offenders == []


#: modules the port keeps as copies of the reference: the same code but
#: for the package name in imports (comments and docstrings may differ)
COPIES = ["core/config.py", "core/logger.py", "observe/registry.py",
          "observe/trace.py", "utils/naming.py", "core/mutable.py",
          "core/units.py", "core/plumbing.py", "core/workflow.py",
          "units/decision.py", "ops/kohonen.py", "resilience/retry.py",
          "loader/normalization.py", "loader/mnist.py", "loader/pickles.py",
          "native/loader_core.cpp", "resilience/supervisor.py",
          "observe/watchtower.py", "models/yale_faces.py",
          "loader/text.py", "serve/metrics.py", "serve/batcher.py",
          "native/infer_core.cpp", "units/lr_adjust.py",
          "units/weights_zerofilling.py", "units/resizable_all2all.py",
          "units/image_saver.py", "units/nn_plotting.py", "plotting.py",
          "loader/interactive.py", "loader/restful.py", "models/wine.py",
          "models/approximator.py", "models/spam.py",
          "models/tv_channels.py", "models/rbm.py", "observe/anatomy.py",
          "observe/federation.py", "observe/__init__.py",
          "resilience/health.py", "resilience/__init__.py",
          "resilience/elastic.py", "models/elastic_drill.py",
          "fleet/__init__.py", "fleet/workers.py", "fleet/router.py",
          "fleet/rollout.py", "fleet/autoscale.py", "fleet/cli.py",
          "learn/__init__.py", "learn/spool.py", "learn/publish.py",
          "learn/bridge.py", "learn/trainer_workflow.py",
          "loader/spool.py"]

#: copies kept under another path than the reference's
_REFERENCE_PATH = {"models/elastic_drill.py": "../tools/elastic_workflow.py"}


def _code(src: str) -> str:
    """AST dump without docstrings, imports renamed to the port."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "znicz_tpu":
            node.module = "znicz_tpu_torch" + node.module[len("znicz_tpu"):]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    with open(os.path.join(REPO, "znicz_tpu",
                           _REFERENCE_PATH.get(rel, rel))) as f:
        ref = f.read()
    with open(os.path.join(REPO, "znicz_tpu_torch", rel)) as f:
        ours = f.read()
    if not rel.endswith(".py"):
        # a native source: byte for byte
        assert ours == ref
        return
    if rel == "core/config.py":
        # the one deliberate difference: the reference's absolute data
        # dirs become dirs under the checkout that holds the package
        ref = re.sub(r'"[^"]*/\.data/(\w+)"', r'os.path.join(_DATA, "\1")',
                     ref)
        ours = ours.replace("import os\n", "")
        ours = re.sub(r"\n_DATA = [^\n]*\n[^\n]*\n", "\n", ours)
    if rel == "plotting.py":
        # the same deliberate difference: the default plots dir lies
        # under the checkout's data dir, core/config.py's _DATA
        ref = re.sub(r'"[^"]*/\.data/(\w+)"', r'os.path.join(_DATA, "\1")',
                     ref)
        ref = ref.replace("from znicz_tpu.core.config import root\n",
                          "from znicz_tpu.core.config import _DATA, root\n")
    if rel == "resilience/elastic.py":
        # the deliberate differences: the workers are this package's CLI,
        # whose name and world (torch.distributed) the CLI's texts give
        for a, b in (('"-m", "znicz_tpu"', '"-m", "znicz_tpu_torch"'),
                     ('prog="znicz_tpu elastic"',
                      'prog="znicz_tpu_torch elastic"'),
                     ("via jax.distributed", "via torch.distributed"),
                     ("worst jax-import + compile time)",
                      "worst torch-import + build time)")):
            assert a in ref
            ref = ref.replace(a, b)
    if rel == "fleet/workers.py":
        # the workers are this package's serving CLIs
        a = '"-m", "znicz_tpu", self.plane'
        assert a in ref
        ref = ref.replace(a, '"-m", "znicz_tpu_torch", self.plane')
    if rel == "fleet/cli.py":
        # the CLI's name, and a package help without the reference's
        # ahead-of-time executables (the port has none)
        for a, b in (('prog="znicz_tpu fleet"',
                      'prog="znicz_tpu_torch fleet"'),
                     ('''"generate plane, forward package — "
                                   "AOT-armed for compile_count == 0 "
                                   "boots — for the serve plane)"''',
                      '''"generate plane, forward package "
                                   "for the serve plane)"''')):
            assert a in ref
            ref = ref.replace(a, b)
    if rel == "loader/spool.py":
        # the port's producer fill also takes the minibatch class
        a = "def fill_batch(self, indices: np.ndarray, count: int) -> dict:"
        assert a in ref
        ref = ref.replace(a, "def fill_batch(self, indices: np.ndarray, "
                             "count: int, cls: int) -> dict:")
    if rel == "core/workflow.py":
        # the one deliberate difference: no JAX compilation cache
        ref = ref.replace("from znicz_tpu import compilecache\n", "")
        ref = ref.replace("        compilecache.ensure()\n", "")
    assert _code(ours) == _code(ref)
