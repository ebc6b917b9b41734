"""The port's sharded train step of the recurrent archs over a model
axis, against the port's single-device step and the JAX reference's
loss, on the CPU, with the states, batches, helpers and tolerances of
``tests/test_torch_sharded_train.py``:

  * rwkv6-3b (2 heads of 64 at smoke size): one head a model shard at
    (2, 2); at (1, 4) 32 of a head's 64 columns a shard, so r, k, v and
    the decay are gathered over the axis and every head runs on every
    shard;
  * recurrentgemma-9b: its 128 RG-LRU channels 64 or 32 a shard (u
    gathered for the gates), its local attention's 4 query heads split
    beside its one replicated KV head;
  * (1, 3) divides none of their widths: every rwkv and rec leaf is
    whole on every shard and each block runs unsummed;

and ``launch.train --mesh 2,2`` of both. They sit in a file of their
own so that a run with one file a worker (``-n``, ``--dist loadfile``)
spreads them over another worker.
"""
import numpy as np
import pytest

from repro_torch.launch import train as launch_train
from repro_torch.training import CheckpointManager, OptimizerConfig
from test_torch_sharded_train import OKW, _check, _ref_loss, _run_pair, _states


@pytest.mark.parametrize("arch,shape", [
    ("rwkv6-3b", (2, 2)), ("rwkv6-3b", (1, 4)), ("rwkv6-3b", (1, 3)),
    ("recurrentgemma-9b", (2, 2)), ("recurrentgemma-9b", (1, 4)),
    ("recurrentgemma-9b", (1, 3))])
def test_recurrent_sharded_step_matches_single_device_and_reference(
        arch, shape):
    """One AdamW step from the reference's state: every gathered leaf
    against the port's single-device step, the loss against the
    reference's."""
    jcfg, tcfg, jstate, fresh = _states(arch, False, "adamw")
    one, m1, two, m2 = _run_pair(tcfg, OptimizerConfig(**OKW), fresh,
                                 shape)
    _check(one, m1, two, m2)
    np.testing.assert_allclose(float(m2["loss"]),
                               _ref_loss(arch, False, jstate, jcfg),
                               rtol=2e-5)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_launch_train_mesh_cpu_recurrent(arch, tmp_path, capsys):
    """``launch.train --mesh 2,2 --device cpu --smoke`` trains the
    recurrent archs over a model axis and checkpoints the last step."""
    launch_train.main(["--arch", arch, "--smoke", "--batch", "4", "--seq",
                       "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                       "--steps", "2", "--mesh", "2,2"])
    assert "done: step=2" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps()[-1] == 2
