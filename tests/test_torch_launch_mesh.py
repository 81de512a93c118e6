"""The training launcher on a mesh (``python -m repro_torch.launch.train
--mesh ...``) on the CPU: one gloo rank a mesh device, spawned by
``dist.launch.spawn_ranks(..., device="cpu")``, reduced gemma-2b (fp32)
on 2x1, 1x2 and 2x1x2 meshes held against the launcher's one-device
run (tests/test_torch_train.py holds that run against JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.dist.launch import AXES
from repro_torch.launch import train as launch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The parent's one-device run is tiny: one intra-op thread (the
    spawned ranks pin their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAUNCH = ["--arch", "gemma-2b", "--reduced", "--steps", "3", "--seq", "16",
          "--device", "cpu"]


@pytest.fixture(scope="module")
def one_device_losses():
    _, hist = launch.main(LAUNCH)
    return [h["loss"] for h in hist]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x1x2"])
def test_launcher_trains_on_a_mesh(mesh, one_device_losses):
    """``--mesh`` spawns a rank a device (gloo on the CPU) and trains on
    the dense placements: reduced gemma-2b's losses within 1e-5
    (tests/test_torch_train.py's AdamW trajectory bound) of the
    one-device run's, every rank alike; each rank counts its step-0
    collectives."""
    ranks, hist = launch.main(LAUNCH + ["--mesh", mesh])
    dims = tuple(int(x) for x in mesh.split("x"))
    assert len(ranks) == int(np.prod(dims))
    assert launch.make_mesh(mesh) == (dims, AXES[len(dims)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    for r in ranks:
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in hist]
        assert r["peak_bytes"] is None and sum(
            r["collectives_step0"].values()) > 0
    np.testing.assert_allclose([h["loss"] for h in hist], one_device_losses,
                               rtol=0, atol=1e-5)
