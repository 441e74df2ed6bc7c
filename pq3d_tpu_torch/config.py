"""The port's configs and their loader; counterpart of
``pq3d_tpu/config/config.py``.

The six packaged configs are the YAML files of ``pq3d_tpu_torch/configs/``
(copies of the JAX package's ``pq3d_tpu/config/configs/``), read by the
port's own YAML reader (``utils/yaml_reader``: no PyYAML).  ``CONFIGS[name]``
is each file as ``yaml.safe_load`` reads it (``${...}`` interpolations left
as strings); ``INSTSEG_SCENEVERSE``, ``INSTSEG_SCENEVERSE_GT`` (the
GT-query variant), ``INSTSEG_SYNTHETIC``, ``INSTSEG_SWIN3D_SYNTHETIC``,
``UNIFIED_TASKS_SCENEVERSE`` and ``UNIFIED_TASKS_SYNTHETIC`` name them, and
``INSTSEG_SCENEVERSE_MODEL`` and ``INSTSEG_SCENEVERSE_OPTIONS`` the first
one's ``model`` and ``data.instseg_options`` sections.  The files are read
at the first use of one of these names.

``load_config(name_or_path, overrides)`` reads a YAML file by path, or a
bare name looked up in ``default_config_dir()`` (``.yaml`` added), applies
dotted ``key=value`` overrides whose values are read as YAML
(``parse_value``, the JAX loader's ``_parse_override_value``), and then
resolves ``${a.b}`` interpolations (a whole-string one keeps the
referenced value's type; one inside a string is replaced by its text;
list indices may stand in the path), as the JAX loader does.  The stage-1
slices add one override, ``model.voxel_encoder.args.pallas_conv: true``,
which routes the decoder's 96/128-channel stride-1 3^3 convs to the
z-run CUDA kernel; ``serving_config`` sets one of the stage-1 serving
layouts up.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Optional, Sequence

from pq3d_tpu_torch.utils import yaml_reader

PACKAGED = ("instseg_sceneverse", "instseg_synthetic",
            "instseg_swin3d_synthetic", "instseg_sceneverse_gt",
            "unified_tasks_sceneverse", "unified_tasks_synthetic")
# module names -> (packaged config, path of keys inside it)
_NAMED = {"INSTSEG_SCENEVERSE": ("instseg_sceneverse",),
          "INSTSEG_SCENEVERSE_MODEL": ("instseg_sceneverse", "model"),
          "INSTSEG_SCENEVERSE_OPTIONS": ("instseg_sceneverse", "data",
                                         "instseg_options"),
          "INSTSEG_SCENEVERSE_GT": ("instseg_sceneverse_gt",),
          "INSTSEG_SYNTHETIC": ("instseg_synthetic",),
          "INSTSEG_SWIN3D_SYNTHETIC": ("instseg_swin3d_synthetic",),
          "UNIFIED_TASKS_SCENEVERSE": ("unified_tasks_sceneverse",),
          "UNIFIED_TASKS_SYNTHETIC": ("unified_tasks_synthetic",)}
_PACKAGED_CACHE: Dict[str, Dict[str, Any]] = {}


def default_config_dir() -> str:
    """The packaged configs' directory."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs")


def _configs() -> Dict[str, Dict[str, Any]]:
    if not _PACKAGED_CACHE:
        _PACKAGED_CACHE.update(
            (name, read_config(config_path(name))) for name in PACKAGED)
    return _PACKAGED_CACHE


def __getattr__(name: str) -> Any:
    if name == "CONFIGS":
        return _configs()
    if name in _NAMED:
        node: Any = _configs()
        for part in _NAMED[name]:
            node = node[part]
        return node
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def config_path(name_or_path: str) -> str:
    """The file ``load_config`` reads, in the JAX loader's order: an
    existing path; else ``default_config_dir()/name``, with ``.yaml``
    added when the name has no YAML extension; else
    ``FileNotFoundError``."""
    if os.path.exists(name_or_path):
        return name_or_path
    candidate = os.path.join(default_config_dir(), name_or_path)
    if not candidate.endswith((".yaml", ".yml")):
        candidate += ".yaml"
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError(f"config not found: {name_or_path}")


def read_config(path: str) -> Dict[str, Any]:
    """The YAML file at ``path`` as a dict (an empty file is ``{}``),
    interpolations unresolved."""
    raw = yaml_reader.load(path)
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a config is a mapping, not a "
                         f"{type(raw).__name__}")
    return raw


_INTERP = re.compile(r"\$\{([^}]+)\}")


class _Missing:
    pass


_MISSING = _Missing()


def _select(cfg: Any, dotted: str, default: Any = None) -> Any:
    """``cfg``'s value at the dotted path (a digit part indexes a list),
    or ``default`` (the JAX ``Config.select``)."""
    node = cfg
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        else:
            return default
    return node


def _resolve(value: Any, root: Dict[str, Any]) -> Any:
    """``value`` with its interpolations resolved against ``root``, dicts
    in place, in the JAX ``_resolve_node``'s order; a missing reference
    raises ``KeyError``."""
    if isinstance(value, dict):
        for k in list(value.keys()):
            value[k] = _resolve(value[k], root)
        return value
    if isinstance(value, list):
        return [_resolve(v, root) for v in value]
    if isinstance(value, str):
        full = _INTERP.fullmatch(value)
        if full:    # a whole-string interpolation keeps the value's type
            ref = _select(root, full.group(1), _MISSING)
            if ref is _MISSING:
                raise KeyError(f"interpolation {value!r} not found")
            return _resolve(copy.deepcopy(ref)
                            if isinstance(ref, (dict, list)) else ref, root)

        def sub(m):
            ref = _select(root, m.group(1), _MISSING)
            if ref is _MISSING:
                raise KeyError(f"interpolation {m.group(0)!r} not found")
            return str(ref)
        return _INTERP.sub(sub, value)
    return value


def parse_value(text: str) -> Any:
    """A ``key=value`` override's value, as the JAX loader reads it: the
    text as a YAML document (``yes`` a bool, ``{a: 1}`` a dict, empty
    None, ``[a, b]`` a list), and a string that ``float`` takes (``1e-4``,
    ``inf``) a float; text the YAML reader refuses stays a string."""
    try:
        value = yaml_reader.loads(text)
    except ValueError:
        return text
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    """Set ``cfg[a][b][c] = value`` for ``dotted = "a.b.c"``; a missing
    or non-mapping level on the way becomes an empty mapping (the JAX
    ``Config.set_dotted``)."""
    *path, leaf = dotted.split(".")
    node = cfg
    for part in path:
        if not isinstance(node.get(part), dict):
            node[part] = {}
        node = node[part]
    node[leaf] = value


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str] = ()
                    ) -> Dict[str, Any]:
    """``cfg`` (changed in place and returned) with the dotted
    ``key=value`` overrides applied, then its interpolations resolved."""
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override must look like key=value, got "
                             f"{ov!r}")
        set_dotted(cfg, key.strip(), parse_value(val))
    return _resolve(cfg, cfg)


def load_config(name_or_path: str, overrides: Sequence[str] = ()
                ) -> Dict[str, Any]:
    """The config at ``name_or_path`` (a YAML file, or a packaged name;
    see ``config_path``) with dotted ``key=value`` overrides applied, then
    interpolations resolved."""
    return apply_overrides(read_config(config_path(name_or_path)),
                           overrides)


def slice_config() -> Dict[str, Any]:
    """The slices' config, interpolations resolved: instseg_sceneverse
    with the ``pallas_conv: true`` override applied."""
    return load_config("instseg_sceneverse",
                       ["model.voxel_encoder.args.pallas_conv=true"])


# the stage-1 serving layouts (the JAX package's tools/bench_serve.py
# variants) as overrides of instseg_sceneverse: the Res16UNet layouts route
# to the z-run kernel (pallas_conv), the swin ones swap the voxel encoder
# for PCDMask3DSwin3DEncoder at the same widths.  Device-built maps need
# the model's caps to equal the pipeline's: dev_maps' level_caps through
# the interpolation, the flat device layouts' lock (serving_config's
# flat_caps) set on both sides; the Res16UNet ones build the z-run plans
# of levels 1-3 on the device, as the bench's dev_maps variant does
_PALLAS = "model.voxel_encoder.args.pallas_conv=true"
_FLAT = "data.instseg_options.flat_pack=true"
_SWIN = ("model.voxel_encoder.name=PCDMask3DSwin3DEncoder",
         "data.instseg_options.stem_mode='none'",
         "data.instseg_options.swin_window=4", _FLAT)
_DEV_FLAT = ("data.instseg_options.device_maps=true",)
_COMPACT = "data.instseg_options.compact_conv=true"
_NATIVE_INT8 = ("model.voxel_encoder.args.grad_mode=native",
                "model.voxel_encoder.args.int8_gather=true")
_DEV_MAPS = (_PALLAS, "data.instseg_options.device_maps=true",
             "model.voxel_encoder.args.device_maps="
             "${data.instseg_options.level_caps}",
             "model.voxel_encoder.args.device_ztriple=true")
_GATHER = "data.instseg_options.stem_mode=gather"
SERVING_LAYOUTS: Dict[str, Sequence[str]] = {
    "rect": (_PALLAS,),
    "dev_maps": _DEV_MAPS,
    "flat_zt": (_PALLAS, _FLAT, "data.instseg_options.ztriple_conv=true"),
    "flat_swin": _SWIN,
    "dev_flat_swin": _SWIN + _DEV_FLAT,
    "dev_flat_zt": (_PALLAS, _FLAT, *_DEV_FLAT,
                    "model.voxel_encoder.args.device_ztriple=true"),
    # the voxel encoder's remaining conv options (the compact layout runs
    # no kernel B1: JAX switches it off for a batch with compact plans)
    "rect_int8": (_PALLAS, *_NATIVE_INT8),
    "rect_sorted": (_PALLAS, "model.voxel_encoder.args.sorted_gather=true"),
    "flat_compact": (_PALLAS, _FLAT, _COMPACT),
    "flat_compact_int8": (_PALLAS, _FLAT, _COMPACT, *_NATIVE_INT8),
    # the 125-tap gather stem (the JAX pipeline's default stem): nbr5_0
    # built by the host, or on the device beside the other maps
    "rect_gather": (_PALLAS, _GATHER),
    "dev_gather": (*_DEV_MAPS, _GATHER,
                   "model.voxel_encoder.args.device_stem=gather"),
}
# the host layout whose collate_flat derives each device layout's lock
LOCK_PROBE = {"dev_flat_swin": "flat_swin", "dev_flat_zt": "flat_zt"}


def serving_config(layout: str = "rect", overrides: Sequence[str] = (),
                   flat_caps: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    """instseg_sceneverse set up to serve ``layout``: ``rect``
    (rectangular, host-built maps), ``dev_maps`` (rectangular, maps and
    z-run plans built on the device: ``voxel_enc.device_maps ==
    level_caps``; the caps must hold every served scene), ``flat_zt`` (the
    flat pack with the z-run gather conv on levels 1-3), ``flat_swin``
    (the flat pack with the Swin3D backbone), or the flat pack with maps
    built on the device, ``dev_flat_swin`` (swin) and ``dev_flat_zt``
    (Res16UNet with the z-run plans built on the device), which need the
    lock ``flat_caps`` (``instseg_pipeline.device_flat_lock`` on the
    ``LOCK_PROBE`` layout's config) as the pipeline's ``flat_shape_caps``
    and the model's ``device_flat_caps``; ``rect_int8`` (``rect`` with
    ``grad_mode: native`` and ``int8_gather``), ``rect_sorted``
    (``sorted_gather``), ``flat_compact`` (the flat pack with
    ``compact_conv``) and ``flat_compact_int8`` (that with ``native`` and
    int8); ``rect_gather`` and ``dev_gather``, ``rect`` and ``dev_maps``
    with the 125-tap gather stem in place of the YAML's dense-block one;
    further ``key=value`` overrides after the layout's."""
    if layout not in SERVING_LAYOUTS:
        raise KeyError(f"unknown serving layout {layout!r}; known: "
                       f"{sorted(SERVING_LAYOUTS)}")
    if (layout in LOCK_PROBE) != (flat_caps is not None):
        raise ValueError(f"layout {layout!r} "
                         + ("needs" if layout in LOCK_PROBE else "takes no")
                         + " flat_caps lock")
    cfg = load_config("instseg_sceneverse",
                      [*SERVING_LAYOUTS[layout], *overrides])
    if flat_caps is not None:
        caps = {k: int(v) for k, v in flat_caps.items()}
        cfg["data"]["instseg_options"]["flat_shape_caps"] = caps
        cfg["model"]["voxel_encoder"]["args"]["device_flat_caps"] = \
            dict(caps)
    return cfg
