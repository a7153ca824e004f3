"""Every public name of the JAX package has a counterpart in the port.

The JAX modules are read with `ast`, so the walk imports no JAX; the port's
modules are imported. For each JAX module this holds every public
module-level function, class and constant, every re-export of a
subpackage's `__init__.py`, and every public method and property of a class
to the port's module of the same path. The fields of a flax `nn.Module` are
its constructor arguments and are not compared (the port's constructors take
torch's arguments); the fields of the plain dataclasses and of the train
states are.

A name the port does not carry under the same name sits in one of two lists,
keyed by the JAX name's dotted path inside the package:

  * `RENAMED`: the port's name (or names) for it, which must exist;
  * `NOT_PORTED`: a one-line reason from ROADMAP's "Do not port" list, which
    must hold: the name (or module) is absent from the port.

The lists are the port's record of what it leaves out on purpose.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import inspect
import pathlib
import textwrap
from typing import Dict, Iterator, List, Tuple, Union

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "dmel_codec_tpu"
PORT = "dmel_codec_tpu_torch"

RENAMED: Dict[str, Union[str, Tuple[str, ...]]] = {
    "ops.anti_alias.fused_anti_alias_activation": "anti_alias_activation",
    "ops.stage_fused.fused_amp_stage_v2": "amp_stage",
    "ops.stage_fused.fused_amp_stage": "amp_stage_v1",
    "models.bigvgan.bigvgan_apply_fused": "FusedBigVGAN",
    "nn.weight_norm.weight_norm_kernel": "weight_norm",
    "nn.weight_norm.WNConv": ("WNConv1d", "WNConv2d"),
}

_MERGE = "merge_small_channels and its helpers: they fold batch into channels to fill the TPU's 128 lanes"
_PALLAS = "the Pallas switches (`use_pallas*`, the no-op `pallas_exact_edges`): the port dispatches by device"
_DFT = "`use_matmul_dft`: the DFT as a matmul on the TPU's MXU, a layout choice"
_LAYOUT = "layout converters (`utils/torch_compat.py`, `models/codec_convert.py`): the port keeps torch's layouts"
_FLAX = ("flax-parameter helpers (`*_params_from_torch*`, `params_from_torch_state_dict`, `init_ecapa_params`, "
         "`cli/common.load_codec_params`): the port loads torch state_dicts as they are")
_SHARDING = "`parallel/mesh.py`'s `batch_sharding`, `replicated` and `shard_batch`: XLA sharding annotations"
_XLA = "XLA constructs (`scan_layers`, `donate`, `jit_*train_step`): the port runs eagerly"
_CONV = "`nn/conv.py`: torch's transposed conv rebuilt on XLA's dilated conv; the port calls torch's own"
_PROFILING = "the tunnel-proof harness in `utils/profiling.py`"
_WARMUP = "the XLA compile cache in `cli/warmup.py`"

NOT_PORTED: Dict[str, str] = {
    # whole modules
    "cli.warmup": _WARMUP,
    "models.codec_convert": _LAYOUT,
    "nn.conv": _CONV,
    "utils.profiling": _PROFILING,
    "utils.torch_compat": _LAYOUT,
    # names
    "cli.common.load_codec_params": _FLAX,
    "dsp.spectrogram.LogMelSpectrogram.use_matmul_dft": _DFT,
    "eval.ecapa.init_ecapa_params": _FLAX,
    "eval.ecapa.ecapa_params_from_torch_state_dict": _FLAX,
    "models.bigvgan.BigVGANConfig.use_pallas_kernel": _PALLAS,
    "models.bigvgan.BigVGANConfig.pallas_exact_edges": _PALLAS,
    "models.bigvgan.BigVGANConfig.merge_small_channels": _MERGE,
    "models.bigvgan.BigVGANConfig.merge_min_channels": _MERGE,
    "models.bigvgan.params_from_torch_state_dict": _FLAX,
    "models.firefly.hifigan_params_from_torch": _FLAX,
    "models.firefly.convnext_encoder_params_from_torch": _FLAX,
    "models.firefly.firefly_params_from_torch": _FLAX,
    "models.firefly.firefly_architecture_params_from_torch": _FLAX,
    "models.seanet.speechtokenizer_params_from_torch": _FLAX,
    "models.transformer.TransformerConfig.scan_layers": _XLA,
    "models.transformer.decoder_params_from_torch": _FLAX,
    "parallel.mesh.batch_sharding": _SHARDING,
    "parallel.mesh.replicated": _SHARDING,
    "parallel.mesh.shard_batch": _SHARDING,
    "train.codec_trainer.CodecTrainer.jit_train_step": _XLA,
    "train.lm_trainer.LMTrainer.jit_train_step": _XLA,
    "train.lm_trainer.LMTrainer.jit_lora_train_step": _XLA,
}


def _module_name(path: pathlib.Path) -> str:
    """dmel_codec_tpu/models/codec.py -> "models.codec"; a package's
    __init__.py -> the package ("" for the top level)."""
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _tree(module: str) -> ast.Module:
    path = JAX_PKG.joinpath(*module.split(".")) if module else JAX_PKG
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return ast.parse(path.read_text())


def _jax_all(package: str) -> List[str]:
    for node in _tree(package).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return []


JAX_MODULES = sorted(_module_name(p) for p in JAX_PKG.rglob("*.py"))
SUBPACKAGES = sorted(m for m in map(_module_name, JAX_PKG.glob("*/__init__.py")) if _jax_all(m))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _is_flax_module(node: ast.ClassDef) -> bool:
    return any(ast.unparse(b) == "nn.Module" for b in node.bases)


def _class_members(node: ast.ClassDef) -> Iterator[str]:
    """Public methods, properties and (outside flax modules) fields."""
    flax = _is_flax_module(node)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not (flax and item.name == "setup"):
                yield item.name
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name) and not flax:
            yield item.target.id
        elif isinstance(item, ast.Assign) and not flax:
            yield from (t.id for t in item.targets if isinstance(t, ast.Name))


def _public_names(module: str) -> Iterator[Tuple[str, str, List[str]]]:
    """(name in the module, key for RENAMED / NOT_PORTED, class members)."""
    is_package = (JAX_PKG.joinpath(*module.split(".")) / "__init__.py").exists() if module else True
    for node in _tree(module).body:
        if isinstance(node, ast.ClassDef):
            members = [m for m in _class_members(node) if _public(m)]
            yield node.name, f"{module}.{node.name}", members
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, f"{module}.{node.name}", []
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id != "__all__":
                    yield t.id, f"{module}.{t.id}", []
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            yield node.target.id, f"{module}.{node.target.id}", []
        elif isinstance(node, ast.ImportFrom) and is_package and (node.module or "").startswith("dmel_codec_tpu."):
            source = node.module[len("dmel_codec_tpu."):]
            for alias in node.names:  # a re-export: keyed by where it is defined
                yield alias.asname or alias.name, f"{source}.{alias.name}", []


def _port_names(key: str, name: str) -> Tuple[str, ...]:
    renamed = RENAMED.get(key, name)
    return (renamed,) if isinstance(renamed, str) else renamed


def _instance_attributes(cls: type) -> set:
    """Names a port class sets on its instances: `self.<name> = ...` and
    registered buffers and parameters, in it and its port bases."""
    names = set()
    for klass in cls.__mro__:
        if not klass.__module__.startswith(PORT):
            continue
        for node in ast.walk(ast.parse(textwrap.dedent(inspect.getsource(klass)))):
            if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store) and \
                    isinstance(node.value, ast.Name) and node.value.id == "self":
                names.add(node.attr)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("register_buffer", "register_parameter") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def _has_member(cls: type, name: str) -> bool:
    if hasattr(cls, name):
        return True
    if dataclasses.is_dataclass(cls) and name in {f.name for f in dataclasses.fields(cls)}:
        return True
    return name in _instance_attributes(cls)


def _port_module(module: str):
    return importlib.import_module(f"{PORT}.{module}" if module else PORT)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in NOT_PORTED:
        assert importlib.util.find_spec(f"{PORT}.{module}") is None, f"{module} is ported: take it off NOT_PORTED"
        return
    port = _port_module(module)
    missing = []
    for name, key, members in _public_names(module):
        if not _public(name) or key in NOT_PORTED:
            continue
        targets = _port_names(key, name)
        found = [getattr(port, t) for t in targets if hasattr(port, t)]
        if len(found) != len(targets):
            missing.append(f"{module}.{name} (port: {', '.join(targets)})")
            continue
        for member in members:
            mkey = f"{key}.{member}"
            if mkey in NOT_PORTED:
                continue
            for cls, target in zip(found, targets):
                if not _has_member(cls, RENAMED.get(mkey, member)):
                    missing.append(f"{module}.{name}.{member} (port: {target})")
    assert not missing, "missing from the port: " + "; ".join(missing)


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_subpackage_all_imports_from_the_port(package):
    """Every name of a JAX subpackage's `__all__` imports from the port's
    subpackage, under its port name, and is in the port's `__all__`."""
    jax_all = _jax_all(package)
    keys = {name: key for name, key, _ in _public_names(package)}
    port = _port_module(package)
    port_all = set(getattr(port, "__all__", ()))
    wanted = [t for name in jax_all if keys[name] not in NOT_PORTED for t in _port_names(keys[name], name)]
    assert [t for t in wanted if not hasattr(port, t)] == []
    assert [t for t in wanted if t not in port_all] == []


def _jax_names() -> set:
    names = set(JAX_MODULES)
    for module in JAX_MODULES:
        for _, key, members in _public_names(module):
            names.add(key)
            names.update(f"{key}.{m}" for m in members)
    return names


@pytest.mark.parametrize("table", ["RENAMED", "NOT_PORTED"])
def test_lists_name_real_jax_names(table):
    """No stale entry: every key names a module or public name of the JAX package."""
    known = _jax_names()
    assert sorted(k for k in globals()[table] if k not in known) == []


@pytest.mark.parametrize("key", sorted(k for k in NOT_PORTED if k not in JAX_MODULES))
def test_not_ported_names_are_absent(key):
    """A name on NOT_PORTED is not in the port: once ported, it leaves the list."""
    module, _, rest = key.rpartition(".")
    while module not in JAX_MODULES:  # a class member: walk up to the module
        module, _, outer = module.rpartition(".")
        rest = f"{outer}.{rest}"
    obj = _port_module(module)
    *path, name = rest.split(".")
    for part in path:
        obj = getattr(obj, part)
    present = _has_member(obj, name) if isinstance(obj, type) else hasattr(obj, name)
    assert not present
