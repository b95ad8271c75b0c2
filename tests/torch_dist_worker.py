"""One rank of a two-process ``torch.distributed`` job of the port on the
CPU (gloo), for tests/test_torch_parallel.py; the counterpart of
tests/dist_worker.py.

Not a test file: the test launches it twice,

    python tests/torch_dist_worker.py RANK WORLD PORT OUT_DIR

and each rank joins the group through the port's own launcher
(``maybe_initialize_distributed`` reading ``M3F_COORDINATOR``), runs every
case of ``CASES`` and writes what it got to ``OUT_DIR/<case>.rank<r>.npz``.
The case builders (configs, seeded global batches, the step loop) are
shared with the test, which runs the same loop in one process on the whole
batch. Imports no JAX.
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the CLI's MetricWriter opens a TensorBoard writer; TensorBoard's optional
# TensorFlow import takes seconds and is not under test here, so it gets its
# built-in stub
sys.modules.setdefault("tensorflow", None)

import numpy as np
import torch

import m3f_torch.config as tc
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import samples_per_window
from m3f_torch.parallel.mesh import local_rows
from m3f_torch.parallel.seqpar import make_sharded_eval_forward
from m3f_torch.train.loop import Trainer

STEPS = 3
CASES = ("audio", "visual", "options", "eval", "tp")   # run in this order


def audio_cfg(mod, num_data=-1, num_model=1):
    """The narrow audio-only model of tests/test_parallel.py, in fp32:
    two-pass CCC (the default), one-pass BatchNorm, EMA; ``num_model`` 2
    makes the two ranks one row of a tensor-parallel mesh."""
    return mod.ExperimentConfig(
        name="dp",
        model=mod.ModelConfig(
            use_audio=True, use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2),
        train=mod.TrainConfig(batch_size=8, ema_decay=0.9,
                              mesh=mod.MeshConfig(num_data=num_data,
                                                  num_model=num_model)))


def visual_cfg(mod, num_data=-1, **model):
    """A few-block fusion model whose stride-1 blocks take the fused conv
    units, in fp32: one-pass CCC plus MSE, two-pass audio BatchNorm."""
    return mod.ExperimentConfig(
        name="dp",
        model=mod.ModelConfig(
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8,
                                     bn_two_pass=True),
            visual=mod.VisualNetConfig(block_channels=(8, 16),
                                       blocks_per_stage=(2, 1),
                                       stem_channels=8, feature_dim=16),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32",
            **model),
        window=mod.WindowConfig(windows_per_clip=2),
        data=mod.DataConfig(synthetic_num_videos=2, synthetic_video_frames=96,
                            image_size=32),
        train=mod.TrainConfig(batch_size=4, ema_decay=0.9, loss="ccc+mse",
                              ccc_stats="one_pass",
                              mesh=mod.MeshConfig(num_data=num_data)))


def case_cfg(case: str):
    if case == "audio":
        return audio_cfg(tc)
    if case == "tp":
        return audio_cfg(tc, num_model=2)
    if case == "options":
        cfg = visual_cfg(tc, dropout=0.3)
        return cfg.replace(data=dataclasses.replace(cfg.data, augment=True))
    return visual_cfg(tc)


def global_batches(cfg, steps: int = STEPS, seed: int = 0):
    """``steps`` global batches of ``cfg.train.batch_size`` sequences from a
    seed: labels, mask (some frames masked out), wav and, with video, uint8
    frames."""
    rng = np.random.RandomState(seed)
    B, W = cfg.train.batch_size, cfg.window.windows_per_clip
    L = cfg.model.frames_per_window
    spw = samples_per_window(cfg.model.mel,
                             cfg.model.audio.mel_frames_per_window)
    out = []
    for _ in range(steps):
        b = {"wav": rng.randn(B, W, spw).astype(np.float32),
             "labels": rng.uniform(-1, 1, (B, W, L, 2)).astype(np.float32),
             "mask": rng.uniform(size=(B, W, L)) > 0.2}
        if cfg.model.use_video:
            s = cfg.data.image_size
            b["video"] = rng.randint(0, 256, (B, W, L, s, s, 3)).astype(np.uint8)
        out.append(b)
    return out


def run_train(cfg, batches, weights=None) -> dict:
    """The step loop: a fresh trainer (``weights`` loaded when given: this
    rank's blocks of them under tensor parallelism), one ``train_step`` a
    batch on this process's rows of it. → flat arrays: loss / grad_norm /
    batch_ccc per step, then params, BN buffers and EMA after the last step
    (whole: the blocks gathered)."""
    tr = Trainer(cfg, device="cpu")
    if weights is not None:
        tr.model.load_state_dict(weights if tr.tp is None
                                 else tr.tp.blocks(weights))
    state = tr.init_state(keep_weights=weights is not None)
    out = {k: [] for k in ("loss", "grad_norm", "batch_ccc")}
    for b in batches:
        m = tr.train_step(state, local_rows(b, tr.mesh))
        for k in out:
            out[k].append(float(m[k]))
    res = {k: np.asarray(v, np.float64) for k, v in out.items()}
    for prefix, group in (("p/", state.params), ("b/", state.bn_state),
                          ("e/", state.ema)):
        for n, t in group.items():
            t = t.detach() if tr.tp is None else tr.tp.full(n, t.detach())
            res[prefix + n] = t.numpy().copy()
    return res


def eval_video(cfg):
    """A synthetic video of 181 frames: an odd window count."""
    c = cfg.replace(data=dataclasses.replace(cfg.data,
                                             synthetic_video_frames=181))
    return SyntheticAVDataset(c.data, c.model.mel).load_video("synth_0000")


def run_eval(cfg) -> dict:
    """Whole-video eval of one synthetic video, fused and chunked, and the
    sequence forward on 3 sequences (an odd count) → flat arrays."""
    tr = Trainer(cfg, device="cpu")
    video = eval_video(cfg)
    fused = tr.evaluate_video(None, video)
    ch = cfg.replace(window=dataclasses.replace(cfg.window,
                                                eval_max_windows=6))
    chunked = Trainer(ch, device="cpu").evaluate_video(None, video)
    b = global_batches(cfg, 1, seed=5)[0]
    feed = {"video": b["video"][:3], "wav": b["wav"][:3]}
    seq = make_sharded_eval_forward(tr.mesh, tr.make_eval_forward())(feed).numpy()
    return {"fused": fused["pred"], "fused_ccc": np.asarray(
                [fused["ccc_v"], fused["ccc_a"]]),
            "chunked": chunked["pred"], "seq": seq}


def init_weights(case: str, out: str):
    """The weights the test left in ``out/<case>.weights.pt`` (the JAX
    package's init; "tp" takes "audio"'s), or None: the port's seeded
    init."""
    path = os.path.join(out, f"{'audio' if case == 'tp' else case}.weights.pt")
    return torch.load(path) if os.path.exists(path) else None


def run_case(case: str, out: str) -> dict:
    """``case``'s results; a training case starts from ``init_weights``."""
    cfg = case_cfg(case)
    if case == "eval":
        return run_eval(cfg)
    return run_train(cfg, global_batches(cfg), init_weights(case, out))


def run_cli(rank: int, world: int, port: int, out: str) -> None:
    """``m3f_torch.main train`` of the narrow audio preset on synthetic data
    through ``--coordinator``, both ranks into one checkpoint directory."""
    from m3f_torch import main as tmain
    rc = tmain.main([
        "train", "--device", "cpu", "--preset", "audio_only", "--no-eval",
        "--coordinator", f"localhost:{port},{world},{rank}",
        "data.synthetic=true", "data.synthetic_num_videos=4",
        "data.synthetic_video_frames=64", "model.audio.channels=[4,8]",
        "model.audio.feature_dim=8", "model.gru.hidden_size=8",
        "train.batch_size=4", "train.num_steps=2", "train.log_every=1",
        "train.checkpoint_every=1", "data.prefetch=0",
        f"train.checkpoint_dir={os.path.join(out, 'cli_ckpt')}"])
    assert rc == 0, rc


def main() -> int:
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from m3f_torch.parallel.mesh import maybe_initialize_distributed
    env = dict(os.environ, M3F_COORDINATOR=f"localhost:{port},{world},{rank}")
    plan = maybe_initialize_distributed(env, device="cpu")
    assert plan.initialize and plan.expect_processes == world, plan
    times = {}
    for case in CASES:
        t0 = time.time()
        res = run_case(case, out)
        times[case] = time.time() - t0
        np.savez(os.path.join(out, f"{case}.rank{rank}.npz"), **res)
    # the CLI launch last: it leaves the group it joined as it found it
    run_cli(rank, world, port, out)
    print(f"RESULT rank={rank} seconds={times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
