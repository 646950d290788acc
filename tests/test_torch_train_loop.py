"""``repro_torch.launch.train`` on the CPU: the reference's
``examples/train_resume.py`` flow (tiny llama, die after step 18 with a
checkpoint every 10, rerun to 30) resumes from step 10's checkpoint and
gives exactly the losses of an uninterrupted run over steps 11-29; the
checkpoint holds the parameters and the optimizer's state under the
reference's paths and shapes; the flags that need a pod or a card refuse
here."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import train as jt
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.launch import train as LT
from repro_torch.train import TrainConfig, init_state

torch.set_num_threads(1)

ARGV = ["--arch", "llama3.2-1b", "--tiny", "--steps", "30", "--batch", "4",
        "--seq", "64", "--device", "cpu"]


def test_resume_reproduces_the_uninterrupted_losses(tmp_path, capsys):
    whole = LT.main(ARGV)
    assert len(whole["losses"]) == 30
    ck = str(tmp_path / "ck")
    died = LT.main(ARGV + ["--ckpt-dir", ck, "--ckpt-every", "10",
                           "--fail-at", "18"])
    assert died["died_at"] == 18
    assert died["losses"] == whole["losses"][:19]
    assert open(os.path.join(ck, "LATEST")).read().strip() == "10"
    resumed = LT.main(ARGV + ["--ckpt-dir", ck, "--ckpt-every", "10"])
    assert "[resume] restored step 10" in capsys.readouterr().out
    # the reference's loop resumes after the restored step: 11 ... 29
    assert resumed["losses"] == whole["losses"][11:]
    assert resumed["monitor"].ready == [0]
    assert resumed["loader"]["gets"] == 19
    assert int(resumed["state"]["step"]) == 30


def test_checkpoint_holds_the_reference_paths_and_shapes():
    jcfg = jcatalog.tiny(jbase.get_config("jamba-1.5-large-398b"))
    tcfg = tcatalog.tiny(tbase.get_config("jamba-1.5-large-398b"))
    want = jax.eval_shape(lambda k: jt.init_state(jcfg, jt.TrainConfig(), k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    state = init_state(tcfg, TrainConfig(), torch.Generator().manual_seed(0),
                       "cpu")
    got = LT.checkpoint_tree(tcfg, state)
    shapes = lambda tree: {p: (tuple(v.shape), str(v.dtype).removeprefix(
        "torch.")) for p, v in _flatten_with_paths(tree)}
    assert shapes(got) == shapes(want)


def test_restore_writes_the_state_back(tmp_path):
    cfg = tcatalog.tiny(tbase.get_config("llama3.2-1b"))
    tc = TrainConfig()
    a = init_state(cfg, tc, torch.Generator().manual_seed(0), "cpu")
    a["opt"]["m"]["final_norm"].fill_(0.25)
    a["step"].fill_(7)
    mgr = LT.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(6, LT.checkpoint_tree(cfg, a))
    b = init_state(cfg, tc, torch.Generator().manual_seed(1), "cpu")
    step, b = LT.restore(cfg, b, mgr)
    assert step == 6 and int(b["step"]) == 7
    for pa, pb in zip(a["params"].parameters(), b["params"].parameters()):
        assert torch.equal(pa, pb)
    assert float(b["opt"]["m"]["final_norm"][0]) == 0.25


def test_mesh_and_missing_card_refuse():
    with pytest.raises(NotImplementedError, match="A7"):
        LT.main(ARGV + ["--mesh"])
    with pytest.raises(NotImplementedError, match="A7"):
        LT.build(None, TrainConfig(), mesh=object())
    if not torch.cuda.is_available():
        argv = [a for a in ARGV if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(argv)
