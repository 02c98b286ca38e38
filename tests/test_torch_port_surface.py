"""The port's surface against the JAX package's, from the sources alone.

Every `.py` of `multimodal_ad_tpu/` and of `multimodal_ad_tpu_torch/` is
parsed with `ast`; neither package is imported, so this runs in about a
second.

- Modules: every JAX module has a port module at the same relative path,
  or an entry in MOVED.
- Names: each public top-level def, class or assignment of a JAX module,
  and each name of its `__all__`, is defined or imported at the top level
  of its counterpart, or has an entry in RENAMED (the port's
  ``module::name``, which must exist) or in ABSENT; each entry of either
  cites the README divergence that states it, which must be in README.md.
- No stale entry: a mapped name still exists in the JAX module, and the
  port does not define it under the same name.
- Slice 14's names (the tie-splitting max pool, the host augmentations,
  `annotate`, the functional pools) and slice 16's (`StemConv`) are
  ported, never absent.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "multimodal_ad_tpu"
PORT = REPO / "multimodal_ad_tpu_torch"

# JAX module -> the port module that holds its counterpart
MOVED = {
    "native/__init__.py": "utils/native_loader.py",  # the decoder's loader
}

# JAX "module::name" -> (the port's "module::name", README divergence)
RENAMED = {
    "data/transforms.py::scale_intensity": ("ops/normalize.py::scale_intensity", 17),
    "data/transforms.py::adaptive_normal": ("ops/normalize.py::adaptive_normal", 17),
    "train/loop.py::make_train_step": ("train/loop.py::train_step", 17),
    "train/loop.py::make_eval_step": ("train/loop.py::eval_step", 17),
    "train/__init__.py::make_train_step": ("train/loop.py::train_step", 17),
    "train/__init__.py::make_eval_step": ("train/loop.py::eval_step", 17),
    "models/unet3d.py::unet_forward_with_features": ("models/unet3d.py::UNet3D", 17),
    "models/__init__.py::unet_forward_with_features": ("models/unet3d.py::UNet3D", 17),
    "ops/fused_gather.py::gather_normalize_pallas": ("ops/fused_gather.py::gather_normalize", 25),
    "ops/fused_gather.py::gather_normalize_xla": (
        "ops/fused_gather.py::gather_normalize_plain", 25),
    "ops/roi_pool.py::roi_pool_pallas": ("ops/roi_pool.py::roi_pool", 25),
    "ops/roi_pool.py::roi_pool_xla": ("ops/roi_pool.py::roi_pool_plain", 25),
    "parallel/mesh.py::data_sharding": ("parallel/mesh.py::shard_batch", 26),
    "parallel/mesh.py::replicated": ("parallel/mesh.py::replicate", 26),
    "train/loop.py::make_stats_pass": ("train/loop.py::recompute_batch_stats", 27),
    "train/autoencoder.py::load_autoencoder_variables": (
        "train/autoencoder.py::load_autoencoder", 27),
}

# JAX "module::name" with no counterpart -> README divergence
ABSENT = {
    "ops/fused_gather.py::LANES": 25,
    "ops/fused_gather.py::HAS_PALLAS": 25,
    "ops/roi_pool.py::HAS_PALLAS": 25,
    "ops/fused_gather.py::flatten_corpus": 25,
    "tabular/icl.py::validated_from_bytes": 27,
    "models/resnet3d.py::ConvBN": 28,
    "models/resnet3d.py::SegHead": 28,
    "models/resnet3d.py::EXPANSION": 28,
    "models/resnet3d_int8.py::split_arrays": 28,
    "models/resnet3d_int8.py::rehydrate": 28,
}

# ported in this slice: never absent
SLICE_14 = [
    "ops/pool.py::max_pool_3d_fast",
    "data/transforms.py::rand_flip",
    "data/transforms.py::rand_rotate",
    "data/transforms.py::rand_zoom",
    "data/transforms.py::VolumeTransform",
    "data/transforms.py::make_transforms",
    "utils/profiling.py::annotate",
    "models/resnet3d.py::max_pool_3d",
    "models/resnet3d.py::avg_pool_3d",
    "models/resnet3d.py::global_avg_pool",
]


# ported in slice 16: never absent
SLICE_16 = ["models/resnet3d.py::StemConv"]


def _modules(root: Path) -> list:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _top_level(tree: ast.Module):
    """Top-level statements, with those under a module-level if / try."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.If):
            todo[:0] = node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo[:0] = node.body + node.orelse + node.finalbody + [
                s for h in node.handlers for s in h.body]
        else:
            yield node


def _assigned(node) -> set:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}


def _all_list(tree: ast.Module) -> list:
    for node in _top_level(tree):
        if isinstance(node, ast.Assign) and "__all__" in _assigned(node):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(path: Path) -> set:
    """Names a module defines at its top level (defs, classes, assignments)."""
    out = set()
    for node in _top_level(_parse(path)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= _assigned(node)
    return out


def available(path: Path) -> set:
    """Names a module defines or imports at its top level."""
    out = defined(path)
    for node in _top_level(_parse(path)):
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return out


def public(path: Path) -> set:
    """A JAX module's public names: top-level definitions without a
    leading underscore, and its `__all__`."""
    return {n for n in defined(path) if not n.startswith("_")} | set(_all_list(_parse(path)))


def counterpart(rel: str) -> Path:
    return PORT / MOVED.get(rel, rel)


def _readme_divergences() -> set:
    text = (REPO / "README.md").read_text()
    section = text[text.index("## Documented divergences"):]
    return {int(n) for n in re.findall(r"^(\d+)\. ", section, re.MULTILINE)}


JAX_MODULES = _modules(JAX_PKG)


def test_both_packages_are_parsed():
    assert len(JAX_MODULES) > 70 and "ops/pool.py" in JAX_MODULES
    assert "ops/pool.py" in _modules(PORT)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_jax_module_has_its_counterpart(rel):
    port = counterpart(rel)
    assert port.is_file(), f"multimodal_ad_tpu/{rel} has no counterpart (MOVED or {port})"
    names = available(port)
    missing = []
    for name in sorted(public(JAX_PKG / rel)):
        key = f"{rel}::{name}"
        if name in names or key in ABSENT:
            continue
        if key in RENAMED:
            module, target = RENAMED[key][0].split("::")
            assert target in available(PORT / module), f"{key} -> {RENAMED[key][0]} is missing"
            continue
        missing.append(name)
    assert not missing, (f"multimodal_ad_tpu/{rel}: {missing} are neither in "
                         f"{port.relative_to(REPO)} nor in RENAMED or ABSENT")


@pytest.mark.parametrize("table", ["RENAMED", "ABSENT"])
def test_map_entries_are_live(table):
    """Each mapped JAX name still exists, and the port does not define it
    under the same name (then the entry is stale)."""
    stale = []
    for key in {"RENAMED": RENAMED, "ABSENT": ABSENT}[table]:
        module, name = key.split("::")
        path = JAX_PKG / module
        if not path.is_file() or name not in public(path):
            stale.append(f"{key}: no such JAX name")
        elif counterpart(module).is_file() and name in defined(counterpart(module)):
            stale.append(f"{key}: the port defines it")
    assert not stale, stale


def test_renamed_targets_exist():
    for key, (target, _) in RENAMED.items():
        module, name = target.split("::")
        assert (PORT / module).is_file() and name in available(PORT / module), (key, target)


def test_every_entry_cites_a_readme_divergence():
    numbers = _readme_divergences()
    cited = {n for _, n in RENAMED.values()} | set(ABSENT.values())
    assert cited <= numbers, sorted(cited - numbers)


def test_moved_modules():
    for src, dst in MOVED.items():
        assert (JAX_PKG / src).is_file(), src
        assert not (PORT / src).is_file(), f"{src} exists in the port: drop it from MOVED"
        assert (PORT / dst).is_file(), dst


def test_this_slice_is_ported():
    for key in SLICE_14 + SLICE_16:
        module, name = key.split("::")
        assert key not in ABSENT and key not in RENAMED, key
        assert name in public(JAX_PKG / module), f"{key} is not a JAX name"
        assert name in defined(PORT / module), f"{key} is not defined in the port"
