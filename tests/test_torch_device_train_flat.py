"""Stage-1 training in the ``dev_flat_zt`` layout (the flat pack with the
flat maps and the z-run plans of levels 1-3 built on the device): the
train step against JAX's and against the port's host-maps step
(``flat_zt``), and ``run.py`` training in it.  The gates are
tests/test_torch_device_train.py's, which this file shares so that
pytest-xdist can run the layouts side by side."""
import torch

from test_torch_device_train import check_layout_step, run_layout

torch.set_num_threads(1)


def test_dev_flat_zt_train_step_matches_jax_and_host_maps(monkeypatch):
    check_layout_step("dev_flat_zt", monkeypatch)


def test_run_trains_dev_flat_zt(tmp_path, monkeypatch):
    run_layout(tmp_path, monkeypatch, "dev_flat_zt", epochs=2)
