"""The port's checkpoints (``aadg_tpu_torch/utils/checkpoint.py``) and
auto-resume, on the CPU: an exact round trip of the whole search state,
the ``latest`` link and ``model_best`` copy, the choice of the run to
resume among sibling run directories, a completed run starting fresh, and
a search of two epochs that is bit-identical to one epoch plus a resumed
one (its checkpoints written on the background thread).

Background writes: the state is copied to the host before ``save``
returns, so updating the modules afterwards does not reach the file; a
writer's exception is re-raised by ``wait_pending_checkpoints`` (and by a
load, which waits first); two saves to one directory run one after the
other, the second joining the first; the writer's own seconds reach
``on_joined`` when it is joined."""

import os
import threading
import time
from pathlib import Path

import pytest
import torch

from aadg_tpu_torch import run as trun
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.engine.search import try_resume
from aadg_tpu_torch.utils import checkpoint as ck
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import CFG, OPTS

ROOT = Path(__file__).resolve().parent.parent
RUN_OPTS = ["DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
            "TRAIN.BATCH_SIZE", "2", "CONTROLLER.M", "2",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.STEPS_PER_EPOCH", "1",
            "TRAIN.WARMUP_EPOCH", "0"]


def _assert_same(a, b, path="state"):
    """Nested dicts/lists of tensors and plain values, equal exactly."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def trained():
    """Port state after one warmup step, so both Adams hold moments."""
    ent = tstate.build_entities(load_config(CFG, OPTS), "search",
                                steps_per_epoch=1, device="cpu")
    sd, cs = tstate.init_state(ent, 0)
    gen = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (1, 3, 64, 64, 3), generator=gen).float()
    masks = torch.randint(0, 3, (1, 3, 64, 64), generator=gen).float() * 127
    batch = (imgs, masks, torch.arange(3)[None])
    tsteps.make_pretrain_step(ent)(sd, batch,
                                   tsteps.draw_pretrain(ent, 3, gen))
    return ent, sd, cs, gen


def _full_state(sd, cs, gen, epoch=3):
    return {"sd": sd.state_dict(), "cs": cs.state_dict(), "epoch": epoch,
            "best_dsc": 0.25,
            "best_metric": {"epoch": 2, "avg_dsc": 0.25, "cup_hd": 12.5},
            "generator": gen.get_state()}


def test_round_trip_is_exact(trained, tmp_path):
    ent, sd, cs, gen = trained
    state = _full_state(sd, cs, gen)
    path = ck.save_checkpoint(state, False, str(tmp_path), "checkpoint_2.pt")
    loaded = ck.load_checkpoint(path)
    _assert_same(loaded, state)
    assert loaded["sd"]["seg_opt"]["count"] == 1
    assert loaded["sd"]["seg_opt"]["opt"]["state"]  # Adam moments saved

    sd2, cs2 = tstate.init_state(ent, 1)
    sd2.load_state_dict(loaded["sd"])
    cs2.load_state_dict(loaded["cs"])
    _assert_same(sd2.state_dict(), sd.state_dict())
    _assert_same(cs2.state_dict(), cs.state_dict())
    gens = [torch.Generator(), torch.Generator()]
    gens[0].set_state(loaded["generator"])
    gens[1].set_state(gen.get_state())
    assert torch.equal(*(torch.rand(8, generator=g) for g in gens))


def test_latest_and_model_best(tmp_path):
    out = str(tmp_path)
    ck.save_checkpoint({"epoch": 1}, True, out, "checkpoint_0.pt")
    ck.save_checkpoint({"epoch": 2}, False, out, "checkpoint_1.pt")
    latest = tmp_path / "latest.pt"
    assert latest.is_symlink() and os.readlink(latest) == "checkpoint_1.pt"
    assert ck.latest_checkpoint(out) == str(
        (tmp_path / "checkpoint_1.pt").resolve())
    assert ck.load_checkpoint(str(tmp_path / "model_best.pt"))["epoch"] == 1
    ck.save_checkpoint({"epoch": 3}, True, out, "checkpoint_2.pt")
    assert ck.load_checkpoint(str(latest))["epoch"] == 3
    assert ck.load_checkpoint(str(tmp_path / "model_best.pt"))["epoch"] == 3
    ck.save_checkpoint({"epoch": 9}, False, out, "final_state.pt",
                       update_latest=False)
    assert ck.load_checkpoint(str(latest))["epoch"] == 3
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]
    assert ck.latest_checkpoint(str(tmp_path / "nothing")) is None


def _run_with_latest(parent, name, epoch, mtime):
    d = parent / name
    path = ck.save_checkpoint({"epoch": epoch}, False, str(d), "c.pt")
    os.utime(path, (mtime, mtime))
    return d


def test_resume_picks_newest_sibling_of_same_stem(tmp_path):
    _run_with_latest(tmp_path, "diversity_2026-10-16-20-00-01", 1, 1000)
    want = _run_with_latest(tmp_path, "diversity_2026-10-16-20-00-05", 2,
                            2000)
    # a newer run of another config whose name extends the stem
    _run_with_latest(tmp_path, "diversity_ablation_2026-10-16-20-00-09", 3,
                     3000)
    # a directory without a checkpoint
    (tmp_path / "diversity_2026-10-16-20-00-07").mkdir()
    current = tmp_path / "diversity_2026-10-16-20-01-00"
    current.mkdir()
    got = ck.find_resume_checkpoint(str(current))
    assert got == str((want / "c.pt").resolve())
    # the run's own latest comes first
    own = _run_with_latest(tmp_path, current.name, 4, 500)
    assert ck.find_resume_checkpoint(str(own)) == str(
        (own / "c.pt").resolve())
    assert ck.find_resume_checkpoint(str(tmp_path / "other_2026-10-16-"
                                         "20-00-00")) is None


@pytest.mark.parametrize("epoch,resumes", [(1, True), (2, False),
                                           (5, False)])
def test_completed_run_starts_fresh(tmp_path, epoch, resumes):
    import logging
    ck.save_checkpoint({"epoch": epoch}, False,
                       str(tmp_path / "diversity_2026-10-16-20-00-00"),
                       "checkpoint_0.pt")
    current = tmp_path / "diversity_2026-10-16-20-00-30"
    cfg = load_config(CFG, OPTS + ["TRAIN.END_EPOCH", "2",
                                   "TPU.AUTO_RESUME", "True"])
    log = logging.getLogger("test_torch_port_checkpoint")
    got = try_resume(cfg, str(current), log)
    assert (got is not None) == resumes
    if resumes:
        assert got["epoch"] == epoch
    cfg.TPU.AUTO_RESUME = False
    assert try_resume(cfg, str(current), log) is None


def _search(out, *extra):
    return trun.main(["--cfg", str(ROOT / CFG), "--device", "cpu",
                      "--output_dir", str(out), *RUN_OPTS,
                      "LOG_DIR", str(out / "log"), *extra])


def test_resumed_search_is_bit_identical(tmp_path):
    """Two search epochs in one run against one epoch, then a second run
    that auto-resumes from its checkpoint: the same weights, controller,
    optimizers, rewards and validation, bit for bit."""
    whole = _search(tmp_path / "whole", "TRAIN.END_EPOCH", "2")
    first = _search(tmp_path / "split", "TRAIN.END_EPOCH", "1")
    resumed = _search(tmp_path / "split", "TRAIN.END_EPOCH", "2",
                      "TPU.AUTO_RESUME", "True")
    assert [e["epoch"] for e in first["epochs"]] == [0]
    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    a, b = whole["epochs"][1], resumed["epochs"][0]
    for k in ("rewards", "raw_rewards", "controller", "metrics", "valid"):
        assert a[k] == b[k], k
    assert whole["best_metric"] == resumed["best_metric"]
    for name in ("final_model_state.pt", "final_controller_state.pt",
                 "checkpoint_1.pt"):
        want = ck.load_checkpoint(os.path.join(whole["out_dir"], name))
        got = ck.load_checkpoint(os.path.join(resumed["out_dir"], name))
        _assert_same(got, want, name)


def test_background_save_copies_the_state_first(trained, tmp_path):
    ent, sd, cs, gen = trained
    want = {k: v.clone() for k, v in sd.model.state_dict().items()}
    path = ck.save_checkpoint({"model": sd.model.state_dict()}, False,
                              str(tmp_path), "c.pt", background=True)
    with torch.no_grad():
        for p in sd.model.parameters():
            p.add_(1.0)
    ck.wait_pending_checkpoints()
    _assert_same(dict(ck.load_checkpoint(path)["model"]), want)
    with torch.no_grad():
        for p in sd.model.parameters():
            p.sub_(1.0)


@pytest.fixture
def failing_write(monkeypatch):
    """torch.save raising on the writer thread."""
    def fail(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(ck.torch, "save", fail)


@pytest.mark.parametrize("join", ["wait", "load", "next_save"])
def test_failing_writer_reraises(tmp_path, failing_write, monkeypatch,
                                 join):
    ck.save_checkpoint({"epoch": 1}, False, str(tmp_path), "c.pt",
                       background=True)
    with pytest.raises(OSError, match="disk full"):
        if join == "wait":
            ck.wait_pending_checkpoints()
        elif join == "load":
            ck.load_checkpoint(str(tmp_path / "c.pt"))
        else:
            ck.save_checkpoint({"epoch": 2}, False, str(tmp_path), "d.pt",
                               background=True)
    monkeypatch.undo()
    ck.wait_pending_checkpoints()   # nothing left pending
    assert not ck._PENDING_SAVE


def test_saves_to_one_directory_serialize(tmp_path, monkeypatch):
    """The second save joins the first before it starts: the writes never
    overlap, ``latest`` ends on the second, and each writer's seconds
    reach its ``on_joined``."""
    save, active, seen = torch.save, [], []
    lock = threading.Lock()

    def slow_save(obj, path):
        with lock:
            active.append(path)
            assert len(active) == 1, active
        time.sleep(0.2)
        save(obj, path)
        with lock:
            active.remove(path)
    monkeypatch.setattr(ck.torch, "save", slow_save)
    out = str(tmp_path)
    for epoch in (1, 2):
        ck.save_checkpoint({"epoch": epoch}, False, out, "c.pt",
                           background=True, on_joined=seen.append)
    assert len(seen) == 1 and seen[0] >= 0.2   # the first, joined
    ck.wait_pending_checkpoints()
    assert len(seen) == 2 and seen[1] >= 0.2
    assert ck.load_checkpoint(str(tmp_path / "latest.pt"))["epoch"] == 2


def test_loop_records_in_loop_and_writer_seconds(tmp_path):
    run = _search(tmp_path, "TRAIN.END_EPOCH", "2")
    for e in run["epochs"]:
        assert 0 < e["checkpoint_seconds"]
        assert 0 < e["checkpoint_write_seconds"]
    assert not ck._PENDING_SAVE
