"""The port's checkpoint manager and its copies of the lock modules.

A tree saved by ``repro_torch.checkpoint.manager`` loads with the JAX
package's ``load_pytree`` leaf for leaf, and the reverse; the port's
``MutableLock`` / ``MutableWait`` / oracles (which guard the checkpoint
writer) pass the deterministic cases of ``tests/test_mutlock.py`` next to
the JAX package's originals.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jmanager
import repro.core.atomic as jatomic
import repro.core.mutlock as jmutlock
import repro.core.oracle as joracle
import repro.core.waitpolicy as jwait
import repro_torch.checkpoint.manager as tmanager
import repro_torch.core.atomic as tatomic
import repro_torch.core.mutlock as tmutlock
import repro_torch.core.oracle as toracle
import repro_torch.core.waitpolicy as twait

PACKAGES = {
    "jax": (jatomic, jmutlock, joracle, jwait),
    "torch": (tatomic, tmutlock, toracle, twait),
}


def _tree():
    rng = np.random.default_rng(0)
    return {
        "out": {"completed": rng.integers(0, 9, 7).astype(np.int32),
                "t_end": rng.random(7).astype(np.float32),
                "lat_hist": rng.integers(0, 3, (7, 64)).astype(np.int32)},
        "wins": rng.integers(0, 5, (8, 15)).astype(np.int32),
        "cursor": np.int64(3),
        "fingerprint": rng.integers(0, 255, 32).astype(np.uint8),
        "failures_json": np.uint32(2),
        "layers": [rng.random((2, 3)).astype(np.float32),
                   {"b": np.arange(4), "a": None},
                   (np.float32(1.5), rng.random(2).astype(np.float16))],
    }


def _leaves(tree):
    return [np.asarray(x) for _, x in tmanager._flatten_with_paths(tree)]


def test_flatten_order_and_paths_equal_jax_tree_util():
    import jax

    tree = _tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in flat]
    tpaths = [p for p, _ in tmanager._flatten_with_paths(tree)]
    assert tpaths == jpaths
    assert "layers/1/b" in tpaths and "out/completed" in tpaths


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = _tree()
    tmanager.save_pytree(tree, str(tmp_path))
    got = jmanager.load_pytree(str(tmp_path), tree)
    import jax.numpy as jnp
    for g, w in zip(_leaves(got), _leaves(tree)):
        assert g.dtype == jnp.asarray(w).dtype     # JAX's 32-bit default
        np.testing.assert_array_equal(g, w)


def test_jax_checkpoint_loads_in_port(tmp_path):
    tree = _tree()
    jmanager.save_pytree(tree, str(tmp_path))
    got = tmanager.load_pytree(str(tmp_path), tree)
    assert list(got) == sorted(tree)
    assert got["layers"][1]["a"] is None
    assert isinstance(got["layers"][2], tuple)
    for g, w in zip(_leaves(got), _leaves(tree)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / "manifest.json") as f:
        assert len(json.load(f)["leaves"]) == len(_leaves(tree))


def test_tensor_leaves_and_template_dtypes(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": torch.tensor([1, 2], dtype=torch.int32)}
    tmanager.save_pytree(tree, str(tmp_path))
    got = tmanager.load_pytree(str(tmp_path), tree)
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())
    assert got["n"].dtype == np.int32
    bad = {"w": torch.zeros(3, 2), "n": tree["n"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        tmanager.load_pytree(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing leaf"):
        tmanager.load_pytree(str(tmp_path), {"x": np.zeros(1)})


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_manager_commits_latest_and_keeps_last(tmp_path,
                                                          async_save):
    root = str(tmp_path / "ck")
    mgr = tmanager.CheckpointManager(root, keep_last=2,
                                     async_save=async_save)
    try:
        for step in (1, 2, 3):
            mgr.save(step, {"x": torch.full((3,), float(step))})
            assert mgr.wait(timeout_s=30)
        assert mgr.latest_step() == 3
        assert sorted(d for d in os.listdir(root)
                      if d.startswith("step_")) == ["step_00000002",
                                                    "step_00000003"]
        step, tree = mgr.restore({"x": np.zeros(3, np.float32)})
        assert step == 3 and tree["x"].tolist() == [3.0, 3.0, 3.0]
        # the JAX manager reads the same directory
        jstep, jtree = jmanager.CheckpointManager(
            root, async_save=False).restore({"x": np.zeros(3, np.float32)})
        assert jstep == 3 and np.asarray(jtree["x"]).tolist() == [3.0] * 3
    finally:
        mgr.close()


# --------------------------------------------------------------------------
# the copied lock modules, both packages, deterministic cases
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lstate_pack_roundtrip_and_fad_fields(pkg):
    atomic = PACKAGES[pkg][0]
    for sws, thc in [(1, 0), (7, 3), (2**31, 2**31), (2**32 - 1, 2**32 - 1)]:
        assert atomic.unpack_lstate(atomic.pack_lstate(sws, thc)) == \
            (sws, thc)
    a = atomic.AtomicU64(atomic.pack_lstate(3, 5))
    a.fetch_add(1)
    assert atomic.unpack_lstate(a.load()) == (3, 6)
    a.fetch_add(atomic.sws_delta(+3))
    assert atomic.unpack_lstate(a.load()) == (6, 6)
    a.fetch_add(atomic.sws_delta(-5))
    assert atomic.unpack_lstate(a.load()) == (1, 6)
    a.fetch_add(-1)
    assert atomic.unpack_lstate(a.load()) == (1, 5)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_oracles_deterministic(pkg):
    oracle = PACKAGES[pkg][2]
    o = oracle.EvalSWS(k=3)
    assert o.eval_sws(spun=False, slept=True, sws=4) == 4
    assert o.eval_sws(spun=True, slept=False, sws=8) == 0
    assert o.eval_sws(spun=True, slept=False, sws=8) == 0
    assert o.eval_sws(spun=True, slept=False, sws=8) == -1
    for name in ("paper", "aimd", "fixed", "history"):
        t = toracle.make_oracle(name, k=4)
        j = joracle.make_oracle(name, k=4)
        for spun, slept, sws in ((0, 1, 2), (1, 0, 3), (0, 0, 5), (0, 1, 1),
                                 (1, 1, 4), (0, 0, 2), (0, 0, 2)):
            assert t.eval_sws(spun, slept, sws) == \
                j.eval_sws(spun, slept, sws), name


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mutable_lock_single_thread_and_non_holder(pkg):
    mutlock = PACKAGES[pkg][1]
    lock = mutlock.MutableLock()
    for _ in range(1000):
        with lock:
            pass
    assert lock.thc == 0 and lock.sws == 1
    lock.acquire()
    err = []

    def bad_release():
        try:
            lock.release()
        except RuntimeError:
            err.append(1)

    t = threading.Thread(target=bad_release)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and err == [1]
    lock.release()
    assert not lock.locked()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mutable_lock_thc_returns_to_zero(pkg):
    mutlock = PACKAGES[pkg][1]
    lock = mutlock.MutableLock(max_sws=4)
    counter = {"v": 0}

    def worker():
        for _ in range(50):
            with lock:
                counter["v"] += 1

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert counter["v"] == 300 and lock.thc == 0
    assert 1 <= lock.sws <= lock.max


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mutable_wait(pkg):
    wait = PACKAGES[pkg][3]
    w = wait.MutableWait(max_spin_s=1e-3, sleep_s=1e-3)
    assert w.wait(lambda: True, timeout_s=1.0)
    assert not w.wait(lambda: False, timeout_s=0.02)
    flag = threading.Event()
    threading.Timer(0.01, flag.set).start()
    assert w.wait(flag.is_set, timeout_s=10.0)
