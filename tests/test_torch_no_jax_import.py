"""The port and its chip smoke script import nothing of JAX or the JAX package.

Every ``.py`` under `pcm_tpu_torch/`, ``chip_smoke.py`` and the port's
profiling and kernel-bench scripts is parsed with `ast`; any ``import`` or ``from ... import``
of ``jax``, ``flax``, ``optax`` or ``pcm_tpu`` (at any depth of the module,
lazy imports inside functions included) fails the test.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "optax", "pcm_tpu"}
FILES = sorted((REPO / "pcm_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "profile_serve_torch.py",
    REPO / "scripts" / "profile_train_torch.py"] + sorted((REPO / "scripts").glob("bench_*.py"))


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [(line, root) for line, root in _imported_roots(ast.parse(path.read_text()))
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_sees_lazy_imports():
    code = "def f():\n    from pcm_tpu.data.tokenizer import resolve_tokenizers\n    import jax.numpy\n"
    assert {root for _, root in _imported_roots(ast.parse(code))} == {"pcm_tpu", "jax"}


def test_the_new_entry_points_are_checked():
    """The hub-weight converter, the generate CLI, Prodigy, the metrics logger,
    the PNG writer, the data-parallel module and its benchmark, the eval
    CLIs, the demo and the modules under them are among the files the check
    parses."""
    names = {str(p.relative_to(REPO)) for p in FILES}
    assert {"pcm_tpu_torch/port_weights.py", "pcm_tpu_torch/generate.py",
            "pcm_tpu_torch/train/prodigy.py", "pcm_tpu_torch/utils/logging.py",
            "pcm_tpu_torch/utils/png.py", "pcm_tpu_torch/parallel/mesh.py",
            "pcm_tpu_torch/parallel/__init__.py", "scripts/bench_ddp_torch.py",
            "pcm_tpu_torch/demo.py", "pcm_tpu_torch/eval_fid.py",
            "pcm_tpu_torch/eval_clip_score.py", "pcm_tpu_torch/models/clip_vision.py",
            "pcm_tpu_torch/utils/fid.py", "pcm_tpu_torch/utils/clip_score.py",
            "pcm_tpu_torch/utils/safety.py", "pcm_tpu_torch/utils/profiling.py",
            "pcm_tpu_torch/data/jpeg.py"} <= names
