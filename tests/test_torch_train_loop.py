"""``repro_torch.launch.train`` on the CPU: the reference's
``examples/train_resume.py`` flow (tiny llama, die after step 18 with a
checkpoint every 10, rerun to 30) resumes from step 10's checkpoint and
gives exactly the losses of an uninterrupted run over steps 11-29; the
checkpoint holds the parameters and the optimizer's state under the
reference's paths and shapes; ``--mesh`` outside a 256-rank world and the
default device without a card refuse here; under torchrun a rank takes
its ``LOCAL_RANK``'s card before it joins the group."""

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
    """``--mesh`` builds the production mesh (16 x 16 ranks): outside a
    world of 256 ranks it raises ValueError, with no fallback to one
    device; without a card the default device refuses."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        LT.main(ARGV + ["--mesh"])
    with pytest.raises(ValueError, match="needs 256 ranks"):
        LT.train_loop(tcatalog.tiny(tbase.get_config("llama3.2-1b")),
                      TrainConfig(), 1, 4, 64, None, use_mesh_flag=True,
                      device="cpu")
    if not torch.cuda.is_available():
        argv = [a for a in ARGV if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(argv)


def test_torchrun_rank_takes_its_local_card(monkeypatch):
    """``--mesh`` under torchrun's environment: the rank makes the card of
    its LOCAL_RANK current before ``init_process_group`` (else every rank
    of a host would put its state on cuda:0 and NCCL would refuse), and
    ``rank_device`` names that card.  The card is faked: the group's
    start stops the run."""
    calls = []

    class Joined(Exception):
        pass

    def join(**kw):
        calls.append(("init_process_group", kw.get("init_method")))
        raise Joined

    monkeypatch.setenv("WORLD_SIZE", "256")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(LT.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(LT.dist, "init_process_group", join)
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    with pytest.raises(Joined):
        LT.main(argv + ["--mesh"])
    assert calls == [("set_device", 3), ("init_process_group", "env://")]
    assert LT.rank_device(None) == torch.device("cuda", 3)
    assert LT.rank_device("cuda:1") == torch.device("cuda", 1)
    # a rank asked for the CPU takes no card
    calls.clear()
    with pytest.raises(Joined):
        LT.main(ARGV + ["--mesh"])
    assert calls == [("init_process_group", "env://")]
    assert LT.rank_device("cpu") == torch.device("cpu")
