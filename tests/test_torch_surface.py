"""The port's public surface against the JAX package's, name for name.

Case 1: every package of ``keras_object_detection_tpu`` that has an
``__init__.py`` is imported with its namesake in
``keras_object_detection_torch``; every public name that the JAX package's
``__init__.py`` binds (its imports, defs, classes and assignments, from an
AST walk, each checked to be an attribute of the imported JAX package) and
every submodule of it must be an attribute of the port's package.

Case 2: for each module file of the JAX package that has a counterpart in
the port (its namesake, or the module ``MODULE_TWINS`` names), every public
top-level ``def``, ``class`` and assignment of the JAX file must be an
attribute of the port's module.

The only exceptions are ``PACKAGE_EXEMPT`` and ``MODULE_EXEMPT``: each entry
names its counterpart in the port (checked to exist) or None with the
reason. An entry whose name the JAX package no longer has, or that the port
has gained, fails the test, so the tables hold no stale entries.
"""

from __future__ import annotations

import ast
import importlib
import os

import pytest

JAX = "keras_object_detection_tpu"
PORT = "keras_object_detection_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (package, name) -> (counterpart in the port, dotted below PORT, or None;
# why the name differs)
PACKAGE_EXEMPT = {
    ("export", "export_stablehlo"): (
        "export.export_program",
        "torch.export's program stands where XLA's StableHLO module did"),
    ("ops", "pallas_nms"): ("ops.cuda_nms", "K1's CUDA twin (nms.cu)"),
    ("ops", "pallas_bn"): ("ops.bn", "K2 / K3's CUDA twins (bn_stats.cu)"),
    ("ops", "pallas_loss"): ("ops.yolo_loss",
                             "K4 / K5's CUDA twins (yolo_loss.cu)"),
    ("ops", "mxu_bn"): (
        "models.layers.MxuBNTrain",
        "bn_mode 'mxu' is XLA, not Pallas: its float32 sums are one "
        "autograd function beside the port's BatchNorm"),
    ("utils", "jax_cache"): (
        None, "XLA's persistent compile cache: eager PyTorch compiles no "
        "program (the kernels' nvcc output is ops/_build.py's)"),
}

# JAX module (dotted below JAX) -> the port's module of the same role where
# the names differ
MODULE_TWINS = {
    "ops.pallas_nms": "ops.cuda_nms",
    "ops.pallas_bn": "ops.bn",
    "ops.pallas_loss": "ops.yolo_loss",
    "ops.mxu_bn": "models.layers",
}

# (JAX module, name) -> (counterpart in the port or None; why)
MODULE_EXEMPT = {
    ("ops.pallas_nms", "pallas_batched_non_max_suppression"): (
        "ops.cuda_nms.cuda_batched_non_max_suppression", "K1's wrapper"),
    ("ops.pallas_nms", "PALLAS_NMS_MAX_N"): (
        "ops.cuda_nms.MAX_N", "the largest N one K1 launch takes"),
    ("ops.pallas_loss", "pallas_yolo_v1_loss"): (
        "ops.yolo_loss.fused_yolo_v1_loss", "K4 / K5's loss function"),
    ("ops.mxu_bn", "mxu_batch_stats"): (
        "models.layers.MxuBNTrain", "its forward computes these sums"),
    ("ops.mxu_bn", "mxu_bn_train"): (
        "models.layers.MxuBNTrain", "the custom-gradient BatchNorm"),
    ("export.litert", "export_stablehlo"): (
        "export.litert.export_program", "torch.export, as in PACKAGE_EXEMPT"),
    ("models.layers", "Dtype"): (None, "a type alias of JAX dtypes"),
    ("models.layers", "FusedBatchNorm"): (
        "models.layers.BatchNorm", "one BatchNorm module for every bn_mode"),
    ("models.layers", "SubsetStatsBatchNorm"): (
        "models.layers.BatchNorm", "bn_mode 'flax@N' of the same module"),
    ("models.layers", "make_batch_norm"): (
        "models.layers.BatchNorm", "the module takes bn_mode itself"),
    ("models.pretrained", "BACKBONE_PARAM_KEYS"): (
        None, "flax's variable-tree name of each backbone; the port's "
        "state_dict holds every backbone under 'backbone.'"),
    ("models.pretrained", "keras_vgg16_to_flax"): (
        "models.pretrained.keras_vgg16_to_torch", "converts to torch"),
    ("models.pretrained", "keras_mobilenetv2_to_flax"): (
        "models.pretrained.keras_mobilenetv2_to_torch", "converts to torch"),
    ("data.augment", "sample_crop_window"): (
        "data.augment.crop_windows", "the windows of AugmentDraws drawn "
        "ahead by sample_augment_draws, not from a JAX key"),
    ("utils.profiling", "op_category"): (
        None, "XLA's HLO op names; the port writes and reads torch traces "
        "only, whose kernels kernel_category names"),
}


def _packages():
    out = []
    for root, dirs, files in os.walk(os.path.join(ROOT, JAX)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        if "__init__.py" in files:
            rel = os.path.relpath(root, os.path.join(ROOT, JAX))
            out.append("" if rel == "." else rel.replace(os.sep, "."))
    return out


def _modules():
    out = []
    for pkg in _packages():
        base = os.path.join(ROOT, JAX, *pkg.split(".") if pkg else [])
        out += [".".join(filter(None, [pkg, f[:-3]]))
                for f in sorted(os.listdir(base))
                if f.endswith(".py") and f != "__init__.py"]
    return out


def _path(module: str, init: bool = False) -> str:
    parts = module.split(".") if module else []
    if init:
        return os.path.join(ROOT, JAX, *parts, "__init__.py")
    return os.path.join(ROOT, JAX, *parts[:-1], parts[-1] + ".py")


def _bound_names(path: str, imports: bool) -> set:
    """Public names a file binds at its top level: defs, classes,
    assignments and (``imports``) imported names."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _submodules(pkg: str) -> set:
    base = os.path.join(ROOT, JAX, *pkg.split(".") if pkg else [])
    return {f[:-3] if f.endswith(".py") else f for f in os.listdir(base)
            if (f.endswith(".py") and f != "__init__.py")
            or os.path.isfile(os.path.join(base, f, "__init__.py"))}


def _import(package: str, module: str):
    return importlib.import_module(".".join(filter(None, [package, module])))


def _resolve(dotted: str):
    """The port's object at ``dotted`` (below PORT): the longest importable
    module prefix, then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        target = ".".join([PORT, *parts[:i]])
        try:
            obj = importlib.import_module(target)
        except ModuleNotFoundError as e:
            if e.name != target:
                raise
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _has(port_obj, port_name: str, name: str) -> bool:
    if hasattr(port_obj, name):
        return True
    target = f"{port_name}.{name}"
    try:  # a submodule that its package has not imported yet
        importlib.import_module(target)
    except ModuleNotFoundError as e:
        if e.name != target:
            raise
        return False
    return hasattr(port_obj, name)


def test_the_walk_finds_every_package():
    assert _packages() == ["", "core", "data", "eval", "export", "losses",
                           "models", "ops", "parallel", "train", "utils"]


@pytest.mark.parametrize("pkg", _packages(), ids=lambda p: p or "top")
def test_every_public_name_of_a_jax_package_is_in_the_port(pkg):
    jax_pkg, port_pkg = _import(JAX, pkg), _import(PORT, pkg)
    names = _bound_names(_path(pkg, init=True), imports=True)
    names |= _submodules(pkg)
    for name in sorted(names):  # the AST walk lists real attributes
        if not hasattr(jax_pkg, name):
            _import(JAX, ".".join(filter(None, [pkg, name])))
        assert hasattr(jax_pkg, name), (pkg, name)
    port_name = ".".join(filter(None, [PORT, pkg]))
    missing = sorted(n for n in names if (pkg, n) not in PACKAGE_EXEMPT
                     and not _has(port_pkg, port_name, n))
    assert not missing, f"{port_name} lacks {missing}"


@pytest.mark.parametrize("module", [m for m in _modules()
                                    if (*m.rsplit(".", 1),) not in
                                    PACKAGE_EXEMPT or m in MODULE_TWINS])
def test_every_public_name_of_a_jax_module_is_in_its_port_twin(module):
    port = _import(PORT, MODULE_TWINS.get(module, module))
    names = _bound_names(_path(module), imports=False)
    missing = sorted(n for n in names if (module, n) not in MODULE_EXEMPT
                     and not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("table", ["package", "module"])
def test_every_exemption_is_live_and_names_a_real_counterpart(table):
    if table == "package":
        entries = [(pkg, name, _submodules(pkg)
                    | _bound_names(_path(pkg, init=True), imports=True),
                    ".".join(filter(None, [PORT, pkg])), v)
                   for (pkg, name), v in PACKAGE_EXEMPT.items()]
    else:
        entries = [(mod, name, _bound_names(_path(mod), imports=False),
                    f"{PORT}.{MODULE_TWINS.get(mod, mod)}", v)
                   for (mod, name), v in MODULE_EXEMPT.items()]
    for where, name, jax_names, port_name, (twin, why) in entries:
        assert why
        assert name in jax_names, f"{where}.{name} is gone from the JAX side"
        port = importlib.import_module(port_name)
        assert not _has(port, port_name, name), (
            f"{port_name} has {name}: drop its exemption")
        if twin is not None:
            assert _resolve(twin) is not None, twin
