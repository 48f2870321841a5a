"""The port's image recipe stays aligned with what its manifests render.

No docker daemon runs here, so ``docker_torch/Dockerfile`` is checked as
``tests/test_docker.py`` checks the JAX platform's recipes: the build
script tags ``kubeflow_tpu_torch/manifests/images.py``'s image, every
``COPY`` source exists, nothing installs JAX or the JAX package, the
``.cu`` sources ship and are built in the image, the entry-point modules
import without JAX, and the final stage does not run as root. The
recipe lies outside ``docker/*/Dockerfile``, the JAX platform's set.
"""

import re
import subprocess
import sys
from pathlib import Path

from kubeflow_tpu_torch.manifests import images

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "docker_torch" / "Dockerfile"
SCRIPT = REPO / "docker_torch" / "build_image.sh"


def _instructions(path: Path) -> list[tuple[str, str]]:
    out, cont = [], None
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if cont is not None:
            cont += " " + line.rstrip("\\").strip()
            if not line.endswith("\\"):
                out.append(tuple(cont.split(None, 1)))
                cont = None
            continue
        if line.endswith("\\"):
            cont = line.rstrip("\\").strip()
            continue
        parts = line.split(None, 1)
        out.append((parts[0], parts[1] if len(parts) > 1 else ""))
    return [(k.upper(), v) for k, v in out]


def _final_stage() -> list[tuple[str, str]]:
    instrs = _instructions(RECIPE)
    last = max(i for i, (k, _) in enumerate(instrs) if k == "FROM")
    return instrs[last:]


def test_recipe_is_outside_the_jax_platform_set():
    assert RECIPE.exists()
    assert RECIPE not in set((REPO / "docker").glob("*/Dockerfile"))


def test_build_script_tags_the_rendered_image():
    proc = subprocess.run(
        ["sh", "-c", SCRIPT.read_text().split("\nTAG=", 1)[1]
         .split("\n", 1)[0].join(["TAG=", "; echo $TAG"])],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == images.TORCH_CUDA, proc.stderr
    assert "--target runtime" in SCRIPT.read_text()


def test_copy_sources_exist_and_the_kernels_ship():
    instrs = _instructions(RECIPE)
    copied = []
    for kind, rest in instrs:
        if kind != "COPY" or "--from=" in rest:
            continue
        *sources, _dest = [t for t in rest.split()
                           if not t.startswith("--")]
        for src in sources:
            assert (REPO / src).exists(), f"COPY {src}"
            copied.append(src)
    assert "kubeflow_tpu_torch" in copied
    assert not any(src.startswith("kubeflow_tpu") and
                   src != "kubeflow_tpu_torch" for src in copied)
    cu = sorted((REPO / "kubeflow_tpu_torch" / "csrc").glob("*.cu"))
    assert cu, "no CUDA sources"
    runs = " ".join(rest for kind, rest in instrs if kind == "RUN")
    assert "kernels.build()" in runs  # every csrc/*.cu, built for sm_90a
    assert "/usr/local/cuda" in RECIPE.read_text()


def test_nothing_installs_jax():
    for kind, rest in _instructions(RECIPE):
        if kind == "RUN" and "pip" in rest:
            words = re.split(r"[\s\"'\[\]=<>]+", rest)
            assert not any(w in ("jax", "jaxlib", "libtpu", "flax",
                                 "optax", ".", "kubeflow-tpu")
                           or w.startswith("jax") for w in words), rest
            assert "pyproject" not in rest


def test_final_stage_does_not_run_as_root():
    users = [rest.strip() for kind, rest in _final_stage() if kind == "USER"]
    assert users and users[-1] not in ("root", "0")
    chowned = " ".join(rest for kind, rest in _final_stage()
                       if kind in ("COPY", "RUN"))
    assert "--chown=kubeflow" in chowned  # build/ and the package


def test_entry_points_import_without_jax():
    final = _final_stage()
    (entry,) = [rest for kind, rest in final if kind == "ENTRYPOINT"]
    module = re.search(r'"-m",\s*"([\w.]+)"', entry).group(1)
    modules = [module, "kubeflow_tpu_torch.manifests.__main__",
               "kubeflow_tpu_torch.operators.__main__",
               "kubeflow_tpu_torch.tuning.sweep",
               "kubeflow_tpu_torch.observability.lint",
               "kubeflow_tpu_torch.serving.scenarios",
               "kubeflow_tpu_torch.serving.batch_predict",
               "kubeflow_tpu_torch.train.loop",
               *(f"kubeflow_tpu_torch.workloads.{m}" for m in (
                   "allreduce_smoke", "tf_cnn", "torch_xla_ddp",
                   "slice_health"))]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'kubeflow_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
