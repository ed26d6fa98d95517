"""The whole-name import guard."""

import subprocess
import sys

from portbench.guard import forbidden_modules
from portbench.tests.conftest import ROOT


def test_whole_top_level_names():
    mods = ["visualslam_tpu_torch", "visualslam_tpu_torch.slam.tracker",
            "jaxtyping", "flax_free", "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["visualslam_tpu.utils.config"]) == [
        "visualslam_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, in a fresh interpreter."""
    code = ("import sys; import portbench.run, portbench.check, "
            "portbench.trace, portbench.control, portbench.world; "
            "import portbench.reference.frontend as f; "
            "import portbench.reference.sift, portbench.reference.orb; "
            "import visualslam_tpu_torch.slam.tracker; "
            "from portbench.guard import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.frontend as f, "
            "portbench.reference.ate, portbench.reference.sift, "
            "portbench.reference.orb; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'visualslam_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
