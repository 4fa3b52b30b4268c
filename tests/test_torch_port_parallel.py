"""The port's data parallelism (``rvc_tpu_torch/parallel``, the sharded
``BucketBatcher``, the train step's gradient sums and the rank-aware
trainer) on the CPU, in gloo process groups of two ranks.

Held to the JAX package: ``make_world_for_batch`` keeps as many devices as
``make_mesh_for_batch``, and each shard of ``BucketBatcher`` is JAX's. Two
ranks launched through ``parallel.launch`` take two steps of a tiny model
(``zero_noise``) on their halves of a global batch whose halves have
different mask sums: their weights are equal to each other bit for bit,
and equal to one process's on the whole batch within 1e-5 (float32; the
sums over ranks add in another order), as are their losses and the norms
of every group of their gradients. ``train --gpu 0-1 --device cpu``
launches two trainer ranks (their weights checked equal at every save):
rank 0 alone writes, a resume at world 2 goes on from the saved step and
optimizer state, and a stop asked of one rank stops both at the same
step. A rank that raises ends the launch with a non-zero code.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

HOP, SEG, T = 64, 36, 40
TINY_MODEL = dict(inter_channels=8, hidden_channels=8, filter_channels=16,
                  n_heads=2, n_layers=1, upsample_initial_channel=16,
                  gin_channels=8, spk_embed_dim=4, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8),
                  upsample_kernel_sizes=(16, 16))
# rank 0's rows are long, rank 1's short: per-rank mask sums differ
LENGTHS = [40, 39, 30, 24]
OPTIONS = {"mpd": {}, "balancer": {"use_balancer": True, "use_multiscale_mel": False}}
LR = 1e-4
# the attention's key bias gets no gradient (the softmax ignores a constant
# per query), so rounding noise sets the sign of its Adam steps: held to 2 lr
VANISHING = "attn_layers.0.conv_k.bias"


def tiny_cfg(**train):
    from rvc_tpu_torch.configs import get_config

    cfg = get_config(48000)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, filter_length=256, hop_length=HOP,
                                 win_length=256),
        model=dataclasses.replace(cfg.model, **TINY_MODEL),
        train=dataclasses.replace(cfg.train, segment_size=SEG * HOP, bf16_run=False,
                                  **train))


def small_mpd(use_spectral_norm=False):
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    return MultiPeriodDiscriminator(periods=(2,), use_spectral_norm=use_spectral_norm)


def global_batch(seed=0):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    tt = np.arange(T * HOP) / 48000
    wave = 0.3 * np.sin(2 * np.pi * 220 * tt)[None, :, None] + 0.05 * rng.normal(
        size=(b, T * HOP, 1))
    lengths = np.array(LENGTHS, np.int64)
    mask = (np.arange(T)[None] < lengths[:, None])
    return {"phone": rng.normal(size=(b, T, 768)).astype(np.float32),
            "phone_lengths": lengths,
            "pitch": rng.integers(1, 255, size=(b, T)).astype(np.int64),
            "pitchf": (150 + 100 * rng.random((b, T))).astype(np.float32),
            "spec": (np.abs(rng.normal(size=(b, T, 129))) * mask[..., None]
                     ).astype(np.float32),
            "spec_lengths": lengths,
            "wave": (wave * np.repeat(mask, HOP, axis=1)[..., None]).astype(np.float32),
            "sid": np.array([0, 3, 1, 2], np.int64)}


def two_steps(option: str, rank: int = 0, world: int = 1):
    """Seeded tiny models, two steps on this rank's rows of the global
    batch: (G and D state dicts, the metrics of each step)."""
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.parallel import shard_rows
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep
    from rvc_tpu_torch.train.trainer import init_parameters

    cfg = tiny_cfg(**OPTIONS[option])
    g = Synthesizer.from_config(cfg, device="cpu", train=True, zero_noise=True)
    d = small_mpd()
    gen = torch.Generator().manual_seed(3)
    init_parameters(g, gen)
    init_parameters(d, gen)
    step = TrainStep(cfg, g, d, module_optimizer("adamw", g, LR),
                     module_optimizer("adamw", d, LR), balancer_freeze_epochs=0,
                     debug_grads=True)
    batch = {k: torch.from_numpy(v) for k, v in
             shard_rows(global_batch(), rank, world).items()}
    host = torch.Generator().manual_seed(11)
    metrics = [{k: float(v) for k, v in step(batch, host).items()} for _ in range(2)]
    return g.state_dict(), d.state_dict(), metrics


def _steps_rank(rank, device, out_dir):
    for option in OPTIONS:
        torch.save(two_steps(option, rank, 2), os.path.join(out_dir, f"{option}_{rank}.pt"))


def test_make_world_for_batch_matches_jax():
    import jax

    from rvc_tpu.parallel import make_mesh_for_batch
    from rvc_tpu_torch.parallel import make_world_for_batch

    devs = jax.devices()
    assert len(devs) == 8
    for b in range(1, 17):
        got = make_world_for_batch(b, [f"cuda:{i}" for i in range(8)])
        assert len(got) == make_mesh_for_batch(b, devs).size, b
        assert got == [f"cuda:{i}" for i in range(len(got))]


@pytest.mark.parametrize("shards", [2, 3])
def test_bucket_batcher_shards_match_jax(shards):
    from rvc_tpu.train.data import BucketBatcher as JaxBatcher
    from rvc_tpu_torch.train.data import BucketBatcher

    class Lengths:  # the batchers read only ``lengths`` until a batch is built
        def __init__(self, seed):
            self.lengths = list(np.random.default_rng(seed).integers(40, 700, size=53))

    for seed in (0, 1, 2):
        ds = Lengths(seed)
        one = BucketBatcher(ds, 2 * shards)
        for epoch in (1, 2, 5):
            steps = []
            for r in range(shards):
                mine = BucketBatcher(ds, 2, shard_index=r, num_shards=shards)
                ref = JaxBatcher(ds, 2, shard_index=r, num_shards=shards)
                got = list(mine.epoch_batches(epoch))
                assert got == list(ref.epoch_batches(epoch))
                assert mine.steps_per_epoch() == ref.steps_per_epoch() == len(got)
                steps.append(got)
            # together the shards are the one-shard batcher's steps
            for j, (frames, ids) in enumerate(one.epoch_batches(epoch)):
                assert all(s[j][0] == frames for s in steps)
                assert sorted(ids) == sorted(i for s in steps for i in s[j][1])


def test_two_ranks_step_as_one_process(tmp_path):
    from rvc_tpu_torch.parallel import launch, shard_rows

    b = {k: torch.from_numpy(v) for k, v in shard_rows(global_batch(), 0, 2).items()}
    b1 = {k: torch.from_numpy(v) for k, v in shard_rows(global_batch(), 1, 2).items()}
    assert b["spec_lengths"].sum() != b1["spec_lengths"].sum()
    assert launch(_steps_rank, ["cpu", "cpu"], args=(str(tmp_path),)) == 0
    for option in OPTIONS:
        g_ref, d_ref, m_ref = two_steps(option)
        (g0, d0, m0), (g1, d1, m1) = (
            torch.load(tmp_path / f"{option}_{r}.pt", weights_only=True) for r in (0, 1))
        assert m0 == m1
        for ref, a, c in ((g_ref, g0, g1), (d_ref, d0, d1)):
            assert ref.keys() == a.keys() == c.keys()
            for k in ref:
                assert torch.equal(a[k], c[k]), (option, k)
                tol = 2 * LR if k.endswith(VANISHING) else 1e-5
                assert torch.allclose(a[k], ref[k], rtol=0, atol=tol), (option, k)
        # losses, gradient norms and every group's norm (gsub_g/*, gsub_d/*)
        for got, ref in zip(m0, m_ref):
            assert got.keys() == ref.keys()
            for k in ref:
                assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6), (option, k)


def write_dataset(root, n=9, seed=0, sr=48000):
    """Clips of 60-119 frames in the filelist layout (float WAV, [T50, 768]
    features, coarse and float f0)."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        frames = int(rng.integers(60, 120))
        tt = np.arange(frames * HOP) / sr
        wav = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.02 * rng.normal(size=tt.size)
        path = os.path.join(root, f"{i}.wav")
        write_wav(path, wav.astype(np.float32), sr, "FLOAT")
        arrays = {"feats": rng.normal(size=(frames // 2 + 1, 768)).astype(np.float32),
                  "f0c": rng.integers(1, 256, size=frames).astype(np.int64),
                  "f0": (150 + 50 * rng.random(frames)).astype(np.float32)}
        for name, a in arrays.items():
            np.save(os.path.join(root, f"{i}.{name}.npy"), a)
        rows.append("|".join([path] + [os.path.join(root, f"{i}.{nm}.npy")
                                       for nm in arrays] + ["0"]))
    with open(os.path.join(root, "filelist.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _tiny_trainer_rank(rank, device, args, stop_after=None, out=None):
    """A ``train`` rank with the tiny model and the small MPD (set in this
    process: a spawned rank does not see the parent's monkeypatches);
    ``stop_after`` asks rank 1 alone to stop after that epoch."""
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.train import trainer as tm

    # the test reads metrics.jsonl; TensorBoard's import (TensorFlow, where
    # installed) would cost a rank seconds
    sys.modules["torch.utils.tensorboard"] = None
    cli.train_config = lambda a: tiny_cfg(batch_size=a.batch_size)
    tm.MultiPeriodDiscriminator = small_mpd
    if stop_after is not None:
        epoch_fn = tm.Trainer.train_epoch

        def train_epoch(self, epoch, gen):
            stats = epoch_fn(self, epoch, gen)
            if rank == 1 and epoch == stop_after:
                tm.request_stop()
            return stats

        tm.Trainer.train_epoch = train_epoch
        fit = tm.Trainer.fit

        def fit_and_record(self):
            fit(self)
            with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
                json.dump({"step": self.step}, f)

        tm.Trainer.fit = fit_and_record
    cli._train_rank(rank, device, args)


def _cli_train(monkeypatch, root, model, epochs, **rank_kw):
    """``cli.main(["train", "--gpu", "0-1", "--device", "cpu", ...])``: the
    launcher the CLI calls starts the ranks with the tiny model."""
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.parallel import mesh

    calls = []
    real = mesh.launch

    def launch(fn, devices, backend=None, args=()):
        calls.append((fn, list(devices)))
        return real(_tiny_trainer_rank, devices, backend, (*args, *rank_kw.values()))

    monkeypatch.setattr(mesh, "launch", launch)
    monkeypatch.chdir(root)
    code = cli.main(["train", "--model_name", model, "--sample_rate", "48000",
                     "--total_epoch", str(epochs), "--batch_size", "4",
                     "--save_every_epoch", "1", "--pretrained", "False",
                     "--gpu", "0-1", "--device", "cpu", "--index_algorithm", "Faiss"])
    assert calls == [(cli._train_rank, ["cpu", "cpu"])]
    return code


def test_cli_trains_on_two_ranks_and_resumes(tmp_path, monkeypatch):
    exp = tmp_path / "logs" / "run"
    os.makedirs(exp)
    write_dataset(str(exp))
    assert _cli_train(monkeypatch, tmp_path, "run", 1) == 0
    g1 = torch.load(exp / "G_1.pth", weights_only=True)
    assert _cli_train(monkeypatch, tmp_path, "run", 2) == 0
    assert sorted(os.path.basename(p) for p in glob.glob(str(exp / "G_*.pth"))) == [
        "G_1.pth", "G_2.pth"]
    recs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    epochs = [r for r in recs if "epoch/avg/loss_gen_all" in r]
    # rank 0 alone logs, one line an epoch; the resumed run goes on from the
    # first run's step and optimizer state
    n = epochs[0]["step"]
    assert n > 0 and [r["step"] for r in epochs] == [n, 2 * n]
    assert json.load(open(exp / "heartbeat.json"))["epoch"] == 2
    g2 = torch.load(exp / "G_2.pth", weights_only=True)
    assert (g1["optimizer"]["count"], g2["optimizer"]["count"]) == (n, 2 * n)
    assert not all(torch.equal(v, g2["model"][k]) for k, v in g1["model"].items())


def test_stop_request_reaches_every_rank(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "logs" / "stop")
    write_dataset(str(tmp_path / "logs" / "stop"))
    assert _cli_train(monkeypatch, tmp_path, "stop", 4, stop_after=1,
                      out=str(tmp_path)) == 0
    steps = [json.load(open(tmp_path / f"rank{r}.json"))["step"] for r in (0, 1)]
    recs = [json.loads(line) for line in open(tmp_path / "logs" / "stop" / "metrics.jsonl")]
    (epoch1,) = [r for r in recs if "epoch/avg/loss_gen_all" in r]
    assert steps == [epoch1["step"]] * 2  # both ranks ended after epoch 1
    exp = tmp_path / "logs" / "stop"
    assert sorted(os.path.basename(p) for p in glob.glob(str(exp / "G_*.pth"))) == [
        "G_1.pth"]


def _failing_rank(rank, device):
    from rvc_tpu_torch.parallel import barrier

    if rank == 1:
        raise RuntimeError("rank 1 fails")
    barrier()  # rank 0 waits for a rank that never comes


def test_a_failing_rank_ends_the_launch():
    from rvc_tpu_torch.parallel import launch

    t0 = time.time()
    assert launch(_failing_rank, ["cpu", "cpu"]) != 0
    assert time.time() - t0 < 60
