"""pq3d_tpu_torch stands alone: it imports neither JAX nor the JAX package,
nor scikit-learn or transformers (the HF tokenizers' optional dependency),
which the card's machine lacks (checked in a
subprocess, since this suite's conftest imports jax), its
entry points (model, server, trainer CLI) refuse to run on a machine
without CUDA unless asked for the CPU, and its config dict is the slices'
YAML."""
import ast
import os
import subprocess
import sys

import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
NEEDED = ["pq3d_tpu_torch." + m for m in (
    "run", "train.trainer", "train.state", "train.checkpoints",
    "train.metrics", "optim.losses", "optim.optimizers", "data.datasets",
    "eval.instseg_eval", "eval.scannet_protocol", "ops.zrun_conv",
    "ops.sparse", "ops.windowed_conv", "data.pool", "data.unified_loader",
    "optim.loss_aggregator", "eval.base", "eval.grounding_eval",
    "eval.qa_eval", "eval.caption_eval", "eval.caption_metrics",
    "eval.text_utils", "data.sceneverse", "data.replica",
    "data.label_utils", "data.scannet200_constants", "ops.device_maps",
    "utils.profiling", "export", "data.augmentor", "data.tokenizers",
    "models.legacy_encoders", "utils.io_utils", "utils.metric_utils",
    "utils.box_utils", "parallel.dist", "parallel.mesh", "parallel.tp",
    "utils.yaml_reader", "config", "ops.hungarian")]
import pq3d_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(pq3d_tpu_torch.__path__,
                                              "pq3d_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "pq3d_tpu", "yaml", "sklearn",
                      "transformers")
             or m.startswith(("jax.", "flax.", "pq3d_tpu.", "sklearn.",
                              "transformers.")))
missing = sorted(set(NEEDED) - set(mods))
print(len(mods), bad, missing)
sys.exit(1 if bad or missing or len(mods) < 40 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _top_imports(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", ["tools/torch_mesh_phase.py",
                                  "tests/_torch_mesh_worker.py",
                                  "tools/torch_assign_phase.py",
                                  "tools/torch_dev_train_phase.py"])
def test_mesh_programs_import_no_jax(path):
    """The mesh's card tool, its CPU ranks' program and the assignment
    and device-map training phases' card tools run the port alone."""
    top = _top_imports(path)
    assert not top & {"jax", "flax", "pq3d_tpu", "yaml", "sklearn"}, top
    assert "pq3d_tpu_torch" in top


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "flax", "pq3d_tpu", "yaml", "sklearn"}, top
    assert "pq3d_tpu_torch" in top


def test_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is moot")
    from pq3d_tpu_torch.config import slice_config
    from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                      pipeline_config)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import InstSegServer
    cfg = slice_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InstSegServer(None, pipeline_config(
            cfg["data"]["instseg_options"]), batch_size=4, num_classes=200)
    from pq3d_tpu_torch import run
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--config-name", "instseg_sceneverse",
                  "data.train=[SyntheticInstSeg]",
                  "data.val=[SyntheticInstSeg]", f"exp_dir={tmp_path}"])
    assert isinstance(InstSegPipelineConfig(), InstSegPipelineConfig)


def test_slice_config_equals_yaml():
    from pq3d_tpu_torch import config
    path = os.path.join(REPO, "pq3d_tpu", "config", "configs",
                        "instseg_sceneverse.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert config.INSTSEG_SCENEVERSE == raw
    assert config.INSTSEG_SCENEVERSE_MODEL == raw["model"]
    assert config.INSTSEG_SCENEVERSE_OPTIONS == \
        raw["data"]["instseg_options"]
    cfg = config.slice_config()
    va = cfg["model"]["voxel_encoder"]["args"]
    assert va.pop("pallas_conv") is True      # the one override
    assert cfg["model"]["unified_encoder"]["args"]["hidden_size"] == 768
    assert cfg["model"]["mask_head"]["args"]["filter_out_classes"] == [0, 2]
    assert "pallas_conv" not in \
        config.INSTSEG_SCENEVERSE_MODEL["voxel_encoder"]["args"]
    path = os.path.join(REPO, "pq3d_tpu", "config", "configs",
                        "instseg_sceneverse_gt.yaml")
    with open(path) as f:
        assert config.INSTSEG_SCENEVERSE_GT == yaml.safe_load(f)
    gt = config.load_config("instseg_sceneverse_gt")
    assert gt["data"]["instseg_options"]["query_sample_strategy"] == "gt"
    assert gt["model"]["use_offline_attn_mask"] is True
    assert gt["model"]["InstSegLoss"]["criterion_type"] == "direct"
    # the GT variant leaves the FPS config's shared sections untouched
    assert config.INSTSEG_SCENEVERSE_OPTIONS["query_sample_strategy"] == \
        "fps"


def test_recipe_entry_points_refuse_cuda_without_a_card(tmp_path):
    """The GT-query variant and a warm-started stage 2 refuse CUDA on a
    machine without a card, as the other entry points do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is moot")
    from pq3d_tpu_torch import run
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--config-name", "instseg_sceneverse_gt",
                  "data.train=[SyntheticInstSeg]",
                  "data.val=[SyntheticInstSeg]",
                  f"exp_dir={tmp_path / 'gt'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--config-name", "unified_tasks_sceneverse",
                  "data.train=[SyntheticRefer]",
                  f"pretrain_ckpt_path={tmp_path}",
                  f"exp_dir={tmp_path / 's2'}"])
