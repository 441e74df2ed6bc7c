"""The port's configs read from YAML files (``pq3d_tpu_torch/config.py``)
against the JAX package's loader (``pq3d_tpu/config/config.py``):

- each packaged copy in ``pq3d_tpu_torch/configs/`` is byte-equal to its
  JAX file, and ``CONFIGS[name]`` equals ``yaml.safe_load`` of it;
- ``load_config(path, overrides)`` equals JAX's ``load_config(path,
  overrides).to_dict()`` on all six files, the overrides covering the
  values where the port's old parser parted from JAX's (``yes``/``on``,
  a flow mapping, ``a: b``, the empty value, ``None``, ``inf`` / ``.inf``
  / ``NaN``, ``1e-4``), an embedded interpolation and a list index in an
  interpolation's path;
- ``parse_value`` equals JAX's ``_parse_override_value``;
- the lookup order (a path, a packaged name with or without ``.yaml``,
  else ``FileNotFoundError``) and a missing reference's ``KeyError``;
- ``python -m pq3d_tpu_torch.run --config-name <relative path>`` trains
  ``instseg_synthetic`` written to a user file at small widths, its
  snapshot equal to JAX's loader on the same file and overrides, and a
  resume from it; the launcher passes such a path on absolute."""
import json
import math
import os
import subprocess
import sys

import pytest
import yaml

from pq3d_tpu.config import config as jconfig
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import launch as tlaunch
from pq3d_tpu_torch import run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "pq3d_tpu", "config", "configs")


def same(a, b):
    """Equal values of equal types; NaN equals NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b) and all(same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", tconfig.PACKAGED)
def test_packaged_copy_is_the_jax_file(name):
    with open(os.path.join(JAX_DIR, f"{name}.yaml"), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(tconfig.default_config_dir(),
                           f"{name}.yaml"), "rb") as f:
        assert f.read() == jax_bytes
    assert same(tconfig.CONFIGS[name], yaml.safe_load(jax_bytes))


# table (a): the override values the port read otherwise before
TABLE_A = ["yes", "no", "on", "Off", "{ground_loss: 10}", "a: b", "",
           "None", "none", "inf", ".inf", "NaN", "1e-4", "null", "~",
           "[a, b]", "[1, 2.5, null]", "'quoted'", "0x10", "1:30",
           "plain text", "x=y", "- a", "[unclosed", "&anchor 1",
           "2001-12-14"]
# the JAX loader reads these, the port's reader refuses them (ROADMAP
# A.15): the override stays the string it was
REFUSED = {"&anchor 1", "2001-12-14"}


@pytest.mark.parametrize("raw", TABLE_A)
def test_parse_value_is_jax(raw):
    got = tconfig.parse_value(raw)
    if raw in REFUSED:
        assert got == raw
        return
    assert same(got, jconfig._parse_override_value(raw)), (raw, got)


OVERRIDES = ["resume=yes", "debug.flag=on", "debug.quiet=Off",
             "model.loss_weights={ground_loss: 10}", "data.pair=a: b",
             "pretrain_ckpt_path=", "data.none_a=None", "data.none_b=none",
             "solver.lr=1e-4", "data.big=inf", "data.big2=.inf",
             "data.nan=NaN",
             "exp_dir=outputs/${name}/seed${rng_seed}",
             "data.first_train=${data.train.0}",
             "data.caps=[1, 2, 3]", "log_every=0x10",
             "new.level.key=${debug.debug_size}"]


@pytest.mark.parametrize("name", tconfig.PACKAGED)
def test_load_config_by_path_is_jax(name):
    path = os.path.join(JAX_DIR, f"{name}.yaml")
    want = jconfig.load_config(path, OVERRIDES).to_dict()
    got = tconfig.load_config(path, OVERRIDES)
    assert same(got, want)
    assert got["exp_dir"] == f"outputs/{want['name']}/seed{want['rng_seed']}"
    # the packaged name reads the same file
    assert same(tconfig.load_config(name, OVERRIDES), want)


def test_lookup_order_and_missing_reference(tmp_path, monkeypatch):
    packaged = os.path.join(tconfig.default_config_dir(),
                            "instseg_synthetic.yaml")
    assert tconfig.config_path("instseg_synthetic") == packaged
    assert tconfig.config_path("instseg_synthetic.yaml") == packaged
    user = tmp_path / "mine.yml"
    user.write_text("name: mine\nsub:\n  a: ${name}\n")
    assert tconfig.config_path(str(user)) == str(user)
    monkeypatch.chdir(tmp_path)
    assert tconfig.load_config("mine.yml") == {"name": "mine",
                                               "sub": {"a": "mine"}}
    with pytest.raises(FileNotFoundError):
        tconfig.load_config("no_such_config")
    with pytest.raises(FileNotFoundError):
        jconfig.load_config("no_such_config")
    for loader in (tconfig.load_config,
                   lambda p, o: jconfig.load_config(p, o)):
        with pytest.raises(KeyError):
            loader("mine.yml", ["name=x${nope.key}"])
        with pytest.raises(KeyError):
            loader("mine.yml", ["name=${sub.b}"])


# instseg_synthetic at the widths of tests/test_torch_trainer.py's TINY
SMALL = ["device=cpu", "data.synthetic.num_train=2",
         "data.synthetic.num_val=2", "data.synthetic.n_points=1200",
         "data.synthetic.n_instances=4", "data.synthetic.n_segments=24",
         "data.instseg_options.num_queries=8",
         "data.instseg_options.max_segments=32",
         "data.instseg_options.max_instances=8",
         "data.instseg_options.voxel_bucket=256",
         "data.instseg_options.level_caps=[2048, 1024, 512, 256, 128]",
         "model.unified_encoder.args.num_attention_heads=4",
         "model.unified_encoder.args.num_layers=1",
         "model.voxel_encoder.args.hlevels=[0]",
         "solver.epochs_per_eval=0", "log_every=1"]


def test_run_reads_a_yaml_file_by_path_and_resumes(tmp_path, monkeypatch):
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    # the in-process resume must not leave signal handlers in this process
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    with open(os.path.join(tconfig.default_config_dir(),
                           "instseg_synthetic.yaml")) as f:
        text = f.read()
    edits = (('name: "instseg-synthetic"', 'name: "user-${rng_seed}"'),
             ("  hidden_size: 128\n", "  hidden_size: 32\n"))
    for old, new in edits:
        assert text.count(old) == 1
        text = text.replace(old, new)
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "user.yaml").write_text(text)
    exp = str(tmp_path / "run")
    args = [*SMALL, "solver.epochs=1", f"exp_dir={exp}"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.run", "--config-name",
         os.path.join("cfgs", "user.yaml"), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(os.path.join(exp, "config.json")) as f:
        snapshot = json.load(f)
    path = str(tmp_path / "cfgs" / "user.yaml")
    assert same(snapshot, jconfig.load_config(path, args).to_dict())
    assert snapshot["name"] == "user-42"
    assert snapshot["model"]["unified_encoder"]["args"]["hidden_size"] == 32
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if '"train"' in line]
    assert steps == [1]
    trainer = trun.main(["--config-name", path, *SMALL, "resume=True",
                         "solver.epochs=2", f"exp_dir={exp}"])
    assert trainer.tracker.epoch == 2 and trainer.step == 2
    assert trainer.cfg["resume"] is True and trainer.cfg["name"] == "user-42"


def test_launcher_passes_a_config_path_on_absolute(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mine.yaml").write_text("name: mine\n")
    absolute = str(tmp_path / "mine.yaml")
    assert tlaunch.absolute_config(
        ["--config-name", "mine.yaml", "a=1"]) == \
        ["--config-name", absolute, "a=1"]
    assert tlaunch.absolute_config(["--config-name=mine.yaml"]) == \
        [f"--config-name={absolute}"]
    assert tlaunch.absolute_config(
        ["--config-name", "instseg_synthetic"]) == \
        ["--config-name", "instseg_synthetic"]
    _, run_args = tlaunch.parse_args(
        ["--nproc-per-node", "2", "--devices", "cpu,cpu", "--",
         "--config-name", "mine.yaml"])
    assert run_args == ["--config-name", absolute]
