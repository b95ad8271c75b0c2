"""Training and whole-video evaluation.

Counterpart of ``m3f/pytorch_tpu/train/loop.py``:

- **Train side:** ``TrainState`` (params, BN state, optimizer state, step,
  EMA shadow, plateau ``lr_mult``), ``BestTracker``, ``make_optimizer``
  (``train/optim.py``), the train step (masked CCC loss, backward, optimizer
  update, ``grad_norm`` and ``batch_ccc`` metrics, the EMA with its ramp and
  its ``accumulate_steps`` rule, ``lr_mult`` post-scaling), ``evaluate`` in
  both CCC conventions and ``fit`` (factory-stream exact resume, log / eval
  / checkpoint cadence, early stop, plateau decays). The state's params and
  BN state are the model's own tensors, updated in place by the optimizer
  and by BatchNorm's running-statistics update, as PyTorch trains.
- **Eval side:** a video's overlapping windows are gathered on the device
  from start indices, grouped into W-window sequences, run through the
  model, and overlap-averaged onto the frame timeline. The padding is the
  reference's, so each window reads the same frames and wav samples:

  - frames padded to ``ceil(n/256)·256 + L``, windows to a multiple of
    ``W·8`` by repeating the last start (masked out of the stitch);
  - wav padded or cut to the bucketed length, sample offsets
    ``round(start/fps·sr)``, and the per-video hop from ``hop_plan``;
  - videos with more than ``window.eval_max_windows`` windows go in chunks
    of that many windows whose partial sums accumulate on the host.

  A state is evaluated with its own params (its EMA shadow when it has
  one) and BN state: through ``torch.func.functional_call`` unless they are
  the model's own tensors.
- **Ensembles:** ``commit_state(state, eval_only=True)`` makes a member
  whose tensors are its own (a state from ``init_state`` aliases the model
  and changes with the next ``init_state`` or step).
  ``predict_ensemble`` / ``evaluate_ensemble`` upload each video once,
  dispatch it against the k states, then collect, and score the per-frame
  float64 mean of the k tracks.
- **Train options:** ``data.augment`` (``ops/augment.py``) and
  ``model.dropout`` draw from generators on the device seeded from
  ``(train.seed, step)`` and ``(train.seed ^ 0x5eed, step)``, so a resumed
  run draws what an uninterrupted one does; ``model.init_from`` fills a
  branch or the whole model after the seeded init
  (``checkpoint.load_pretrained_init``); ``fit(metric_writer=)`` writes the
  reference's rows (``utils/logging.MetricWriter``).
- **``train.debug_nans``:** the JAX package turns on ``jax_debug_nans``, so
  the first non-finite value of a step raises ``FloatingPointError``. Here
  each step's backward runs under ``torch.autograd.detect_anomaly(
  check_nan=True)`` and its loss and gradient norm are checked (a read of
  the card each step); the first non-finite one raises
  ``FloatingPointError`` naming the step. The flag is the config's, so
  every caller of ``fit`` / ``train_step`` gets it.

- **fp32 on the card:** a train step's forward and backward run inside
  ``M3F.precision()`` (no TF32 in cuDNN's convs and cuBLAS's products),
  and the fused conv units run their fp32 kernels, forward and backward
  (``ops/conv_bn.py``, ``csrc/conv_bn_f32.cu``), so
  ``model.compute_dtype="float32"`` trains on the card as bf16 does.

- **Data parallelism** (``train.mesh.num_data``; ``parallel/mesh.py``):
  in a ``torch.distributed`` group each process is one rank of the data
  axis and trains on its rows of the global batch (``train_step`` and
  ``fit`` take this process's rows, as the reference's multi-process step
  takes each process's local shard). Rank 0's initial state is broadcast;
  BatchNorm's and the loss's statistics cover the global batch; the
  augmentation and dropout draws are the global batch's; the gradients are
  summed over the ranks before the clip, so the optimizer, EMA and
  ``lr_mult`` stay replicated and a step equals the one-process step on the
  whole batch. The whole-video eval splits a video's W-window sequences
  over the ranks and gathers the predictions back (``parallel/seqpar.py``),
  so every rank gets the same evals and best-checkpoint choices.
- **Tensor parallelism** (``train.mesh.num_model > 1``): the processes form
  ``num_data`` rows of ``num_model``; the ranks of a row hold the same rows
  of the batch and the model is tensor-parallel over them (the BiGRU
  column-parallel, the fusion head row-parallel: ``M3F.shard``). A rank
  holds only its block of each sharded parameter (``TrainState.tp``), and
  so of its Adam moments, gradient accumulator and EMA shadow; the batch
  reductions and the gradient sum run over the data axis (the rank's
  column), and the gradient norm of the clip and of ``grad_norm`` adds the
  sharded blocks' squares over the row (``optim.global_norm``), so a step
  equals the one-process step. Every rank builds the one-process init from
  the seed and keeps its blocks; checkpoints hold whole arrays
  (``train/checkpoint.py``).

``make_eval_forward`` is the streaming sessions' group forward (a host
feed of W-window sequences → per-frame predictions). ``fit`` traces steps
start+2 to start+12 into ``train.profile_dir`` (``utils/profiling.trace``)
when it is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from m3f_torch.config import ExperimentConfig
from m3f_torch.models.m3f import M3F
from m3f_torch.nn import resolve_device
from m3f_torch.ops.augment import augment_clips
from m3f_torch.ops.ccc import (ccc, ccc_from_stats, ccc_loss,
                               ccc_sufficient_stats, make_loss)
from m3f_torch.ops.stitch import (coverage_matrix, smooth_moving_average,
                                  stitch_framewise, stitch_framewise_sums,
                                  window_starts)
from m3f_torch.parallel.mesh import (TensorParallel, broadcast_, create_mesh,
                                     data_parallel, sum_grads, tensor_parallel,
                                     world_axis)
from m3f_torch.parallel.seqpar import make_sharded_eval_forward
from m3f_torch.train.checkpoint import load_pretrained_init
from m3f_torch.train.optim import global_norm, make_optimizer
from m3f_torch.utils.profiling import trace

Tensors = Dict[str, torch.Tensor]


def _step_seed(base: int, step: int) -> int:
    """The seed of a step's generator, a fixed function of ``(base, step)``:
    splitmix64 of the pair, so that its low 32 bits, all that a CPU
    generator takes, depend on both."""
    m = (1 << 64) - 1
    z = ((((base % (1 << 32)) << 32) | (step % (1 << 32)))
         + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


def _in_flight(videos, dispatch, collect, pipeline: int):
    """(video_id, ``collect(dispatch(video))``) over (video_id, video)
    pairs, in input order, with ``max(pipeline, 1)`` videos dispatched
    before the oldest is collected."""
    inflight = []
    for vid, video in videos:
        inflight.append((vid, dispatch(video)))
        if len(inflight) >= max(pipeline, 1):
            v, pending = inflight.pop(0)
            yield v, collect(pending)
    for v, pending in inflight:
        yield v, collect(pending)


def _mean_track(preds: List[np.ndarray]) -> np.ndarray:
    """Per-frame mean of k prediction tracks, in float64, as float32."""
    return np.mean(preds, axis=0, dtype=np.float64).astype(np.float32)


@dataclasses.dataclass
class TrainState:
    """The reference's TrainState. ``params`` / ``bn_state`` map the model's
    parameter / buffer names to the model's own tensors; ``ema`` is a
    separate fp32 copy of the params (``train.ema_decay > 0``) or None;
    ``lr_mult`` the plateau multiplier (``optim.schedule == "plateau"``) or
    None; ``tp`` the tensor-parallel layout (the reference's shardings:
    which params, moments and EMA leaves this rank holds as its block) or
    None, every leaf whole."""
    params: Tensors
    bn_state: Tensors
    opt_state: dict
    step: int
    ema: Optional[Tensors] = None
    lr_mult: Optional[float] = None
    tp: Optional[TensorParallel] = None


class BestTracker:
    """Best-metric and patience tracking: ``update(metric)`` →
    ``(is_best, should_stop)``; higher is better; ``patience=0`` never
    stops."""

    def __init__(self, patience: int = 0, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = -float("inf")
        self.best_step = -1
        self.bad_evals = 0

    def update(self, metric: float, step: int = -1) -> Tuple[bool, bool]:
        if metric > self.best + self.min_delta:
            self.best = metric
            self.best_step = step
            self.bad_evals = 0
            return True, False
        self.bad_evals += 1
        return False, self.patience > 0 and self.bad_evals >= self.patience


def _host_ccc(pred: np.ndarray, target: np.ndarray, valid: np.ndarray,
              eps: float = 1e-8) -> np.ndarray:
    """Per-dim masked CCC in numpy fp64 (two-pass moments)."""
    m = valid.astype(np.float64)[:, None]
    p = pred.astype(np.float64)
    t = target.astype(np.float64)
    cnt = np.maximum(m.sum(axis=0), 1e-12)
    mu_p = (p * m).sum(axis=0) / cnt
    mu_t = (t * m).sum(axis=0) / cnt
    dp = (p - mu_p) * m
    dt = (t - mu_t) * m
    cov = (dp * dt).sum(axis=0) / cnt
    var_p = (dp * dp).sum(axis=0) / cnt
    var_t = (dt * dt).sum(axis=0) / cnt
    return 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)


@contextlib.contextmanager
def _nan_guard(step: int):
    """``train.debug_nans`` around one step's forward and backward: anomaly
    mode's refusal of a NaN that a backward function returns becomes a
    ``FloatingPointError`` naming the step."""
    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            yield
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(
                f"train.debug_nans: NaN in the backward at step {step}: "
                f"{e}") from e


class Trainer:
    """Owns the model (seeded from ``train.seed``), trains it and evaluates
    whole videos. ``device="cuda"`` (default) raises without a GPU; the
    tests pass ``device="cpu"`` to run the plain versions."""

    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        d = cfg.train.ema_decay
        if not 0.0 <= d < 1.0:
            raise ValueError(f"train.ema_decay must be in [0, 1), got {d}")
        if cfg.train.eval_ccc_convention not in ("per_video", "pooled"):
            raise ValueError(
                "train.eval_ccc_convention must be 'per_video' or 'pooled', "
                f"got {cfg.train.eval_ccc_convention!r}")
        if cfg.model.per_frame \
                and cfg.model.frames_per_window != cfg.window.window_frames:
            raise ValueError(
                f"window.window_frames={cfg.window.window_frames} but "
                f"model.frames_per_window={cfg.model.frames_per_window} — "
                "these must match")
        # the mesh over the processes of the torch.distributed group (one
        # process without one); a mesh it cannot build is refused
        self.mesh = create_mesh(cfg.train.mesh.num_data,
                                cfg.train.mesh.num_model)
        if cfg.train.batch_size % self.mesh.size:
            raise ValueError(
                f"train.batch_size={cfg.train.batch_size} must be divisible "
                f"by the {self.mesh.size} rows of the data axis")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = M3F(cfg.model, device=self.device,
                         generator=torch.Generator().manual_seed(cfg.train.seed))
        self.tp = tensor_parallel(
            {n: p.shape for n, p in self.model.named_parameters()},
            self.mesh.model)
        if self.tp is not None:
            self.model.shard(self.tp)
        self.tx = make_optimizer(cfg.train.optim, cfg.train.num_steps,
                                 tp=self.tp)
        self.loss_fn = make_loss(cfg.train.loss, cfg.train.mse_weight,
                                 cfg.train.ccc_stats)
        self._last_state: Optional[TrainState] = None   # SIGTERM save

    # -- state --------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None, *,
                   keep_weights: bool = False) -> TrainState:
        """A fresh state: step 0, fresh optimizer state, the EMA shadow a
        copy of the params. By default the model's parameters and buffers
        are re-initialized from ``train.seed`` (or ``seed``), as a new
        ``Trainer(cfg)``'s are, in place: the tensors keep their identity,
        so whatever was built on ``Trainer.model`` stays valid.
        ``model.init_from`` then fills its branch (or the whole model) from
        that file. ``keep_weights=True`` starts from what the caller loaded
        into ``self.model`` instead; it and ``model.init_from`` are
        refused together. The state's params and BN state are the model's
        own tensors: ``commit_state(..., eval_only=True)`` snapshots them.
        Under tensor parallelism the model holds this rank's blocks (the
        caller loads blocks, e.g. ``checkpoint.from_jax_params(..., tp=)``),
        and the seeded init is the one-process init's blocks."""
        init_from = self.cfg.model.init_from
        if keep_weights and init_from:
            raise ValueError(
                f"model.init_from={init_from!r} and keep_weights=True both "
                "name the starting weights; pass one of them")
        if not keep_weights:
            seed = self.cfg.train.seed if seed is None else seed
            fresh = M3F(self.cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
            sd = fresh.state_dict()
            if init_from:
                sd = load_pretrained_init(sd, init_from)
            if self.tp is not None:
                sd = self.tp.blocks(sd)
            self.model.load_state_dict(sd)
        # every rank starts from rank 0's weights, and its blocks from the
        # first rank of its data axis (which holds the same blocks)
        sd = self.model.state_dict()
        tp = self.tp
        broadcast_([t.data for n, t in sd.items()
                    if tp is None or not tp.sharded(n)], world_axis())
        if tp is not None:
            broadcast_([t.data for n, t in sd.items() if tp.sharded(n)],
                       self.mesh)
        params = dict(self.model.named_parameters())
        ema = ({n: p.detach().clone() for n, p in params.items()}
               if self.cfg.train.ema_decay > 0 else None)
        lr_mult = 1.0 if self.cfg.train.optim.schedule == "plateau" else None
        return TrainState(params, dict(self.model.named_buffers()),
                          self.tx.init({n: p.detach() for n, p in params.items()}),
                          0, ema, lr_mult, tp)

    def commit_state(self, state: TrainState,
                     eval_only: bool = False) -> TrainState:
        """``state`` on the trainer's device (a host-loaded state, e.g. from
        ``load_model_checkpoint``, is moved; tensors already there stay as
        they are).

        ``eval_only``: the state will only be evaluated. The EMA policy is
        folded in first (``eval_state``), then the optimizer state and the
        EMA shadow are dropped, and the params and BN state become detached
        copies of their own, never the model's tensors: an ensemble member
        that a later ``init_state`` or train step cannot change, holding
        its parameters once and no Adam moments."""
        dev = self.device
        if eval_only:
            st = self.eval_state(state)
            own = {n: t.detach().to(dev, copy=True) for n, t in st.params.items()}
            return dataclasses.replace(
                st, params=own, ema=None, opt_state=None,
                bn_state={n: t.detach().to(dev, copy=True)
                          for n, t in st.bn_state.items()})

        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            return tree.to(dev) if isinstance(tree, torch.Tensor) else tree
        return dataclasses.replace(
            state, params=move(state.params), bn_state=move(state.bn_state),
            opt_state=move(state.opt_state),
            ema=None if state.ema is None else move(state.ema))

    def eval_state(self, state: TrainState) -> TrainState:
        """The state whose params are the EMA shadow when EMA is on."""
        if state.ema is not None:
            return dataclasses.replace(state, params=state.ema)
        return state

    # -- steps --------------------------------------------------------------

    def _to_device(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _loss_fn(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None):
        preds = self.model.forward_train(video=batch.get("video"),
                                         wav=batch.get("wav"),
                                         mel=batch.get("mel"),
                                         hop=batch.get("hop"),
                                         generator=generator)
        return self.loss_fn(preds, batch["labels"], batch["mask"]), preds

    def _step_generator(self, base: int, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _step_seed(base, step))

    def train_step(self, state: TrainState,
                   batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (host numpy or tensors: labels,
        mask, and video / wav / mel / hop as the model needs), in place on
        ``state``. Returns the metrics as 0-d device tensors (reading them
        waits for the step). With ``data.augment`` the video is augmented
        on the device, and with ``model.dropout > 0`` the forward drops
        out, each from a generator seeded from the step (module doc). In a
        process group ``batch`` is this process's rows of the global batch
        (``parallel.mesh.local_rows``), and the step is the one-process
        step on the global batch (module doc)."""
        tcfg, dcfg = self.cfg.train, self.cfg.data
        batch = {k: v if isinstance(v, torch.Tensor) else self._to_device(v)
                 for k, v in batch.items()}
        names = list(state.params)
        step = state.step + 1
        with data_parallel(self.mesh):
            if dcfg.augment and "video" in batch:
                batch["video"] = augment_clips(
                    batch["video"], flip_prob=dcfg.aug_flip_prob,
                    brightness=dcfg.aug_brightness,
                    contrast=dcfg.aug_contrast,
                    compute_dtype=self.model.dtype,
                    generator=self._step_generator(tcfg.seed, state.step))
            drop_gen = (self._step_generator(tcfg.seed ^ 0x5eed, state.step)
                        if self.cfg.model.dropout > 0.0 else None)
            with (_nan_guard(step) if tcfg.debug_nans
                  else contextlib.nullcontext()), self.model.precision():
                loss, preds = self._loss_fn(batch, drop_gen)
                grads = torch.autograd.grad(
                    loss, [state.params[n] for n in names], allow_unused=True)
            with torch.no_grad():
                batch_ccc = 1.0 - ccc_loss(
                    preds, batch["labels"], batch["mask"],
                    one_pass=tcfg.ccc_stats == "one_pass")
        grads = [torch.zeros_like(state.params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        # summed, not averaged: each rank's gradient covers its own rows of
        # the one global loss
        sum_grads(grads, self.mesh)
        grads = dict(zip(names, grads))
        with torch.no_grad():
            params = {n: p.detach() for n, p in state.params.items()}
            updates, state.opt_state = self.tx.update(grads, state.opt_state,
                                                      params)
            if state.lr_mult is not None:
                mult = torch.tensor(state.lr_mult, dtype=torch.float32)
                updates = {n: u * mult.to(u.device) for n, u in updates.items()}
            for n, p in params.items():
                p.add_(updates[n])
            metrics = {"loss": loss.detach(),
                       "grad_norm": global_norm(grads, self.tp),
                       "batch_ccc": batch_ccc}
            if tcfg.debug_nans:
                for k in ("loss", "grad_norm"):
                    if not torch.isfinite(metrics[k]).item():
                        raise FloatingPointError(
                            f"train.debug_nans: non-finite {k} "
                            f"({metrics[k].item()}) at step {step}")
            if state.ema is not None:
                self._update_ema(state, params)
        state.step += 1
        self._last_state = state
        return metrics

    def _update_ema(self, state: TrainState, params: Tensors) -> None:
        """shadow ← shadow·d + params·(1−d), with the ramp
        d = min(d, (1+t)/(10+t)) over applied updates t; under gradient
        accumulation only on the steps that applied an update."""
        tcfg = self.cfg.train
        k = max(tcfg.optim.accumulate_steps, 1)
        if k > 1 and state.opt_state["mini_step"] != 0:
            return
        d = torch.tensor(tcfg.ema_decay, dtype=torch.float32)
        if tcfg.ema_ramp:
            t = torch.tensor(float(state.step // k), dtype=torch.float32)
            d = torch.minimum(d, (1.0 + t) / (10.0 + t))
        for n, e in state.ema.items():
            dd = d.to(e.device)
            e.copy_(e * dd + params[n] * (1.0 - dd))

    # -- whole-video eval ---------------------------------------------------

    def make_eval_forward(self) -> Callable[[Dict[str, np.ndarray]],
                                            torch.Tensor]:
        """Eval forward of a batch of W-window sequences: a host feed
        {video [b, W, L, S, S, 3] uint8, wav [b, W, spw], hop [b] (a
        dynamic-hop batch: each entry's own mel hop)}, as the model needs,
        is uploaded and run through the model's no-grad forward with its
        own weights → [b, W, L, 2] on the device."""
        def fwd(feed: Dict[str, np.ndarray]) -> torch.Tensor:
            dev = {k: self._to_device(v) for k, v in feed.items()}
            return self.model(video=dev.get("video"), wav=dev.get("wav"),
                              mel=dev.get("mel"), hop=dev.get("hop"))
        return fwd

    def _win_bucket(self) -> int:
        """Window-count granularity of eval dispatches: whole W-window
        sequences, in groups the data axis divides evenly (the
        reference's)."""
        n_data = self.mesh.size
        return self.cfg.window.windows_per_clip \
            * (8 * n_data // math.gcd(8, n_data))

    def eval_buckets(self, n_frames: int) -> Optional[Tuple[int, int]]:
        """(n_frames_pad, n_win_pad) of the fused eval for an ``n_frames``
        video, or None when it goes through the chunked eval."""
        wcfg = self.cfg.window
        L = wcfg.window_frames
        n_win = len(window_starts(n_frames, L, wcfg.eval_stride))
        if wcfg.eval_max_windows and n_win > wcfg.eval_max_windows:
            return None
        wb = self._win_bucket()
        n_win_pad = -(-max(n_win, 1) // wb) * wb
        n_frames_pad = -(-n_frames // 256) * 256 + L
        return n_frames_pad, n_win_pad

    def _windowed_forward(self, starts: np.ndarray, sample_starts: np.ndarray,
                          frames: Optional[torch.Tensor],
                          wav: Optional[torch.Tensor], spw: int,
                          hop: Optional[int],
                          weights: Optional[Tensors] = None) -> torch.Tensor:
        """Gather each window's frames / samples on the device, group them
        into W-window sequences and run the model (with ``weights`` in place
        of its own parameters when given) → [Nw/W, W, L, 2]. In a process
        group each rank runs its share of the sequences and gathers the
        rest (``parallel/seqpar.py``)."""
        W = self.cfg.window.windows_per_clip

        def run(share: Dict[str, np.ndarray]) -> torch.Tensor:
            return self._run_windows(share["starts"].reshape(-1),
                                     share["sample_starts"].reshape(-1),
                                     frames, wav, spw, hop, weights)
        return make_sharded_eval_forward(self.mesh, run)(
            {"starts": np.asarray(starts).reshape(-1, W),
             "sample_starts": np.asarray(sample_starts).reshape(-1, W)})

    def _run_windows(self, starts, sample_starts, frames, wav, spw: int,
                     hop: Optional[int], weights: Optional[Tensors]
                     ) -> torch.Tensor:
        """``_windowed_forward``'s gather and forward on this process."""
        L = self.cfg.window.window_frames
        W = self.cfg.window.windows_per_clip
        n_win = len(starts)
        dev = self.device
        feed = {}
        if frames is not None:
            idx = torch.as_tensor(starts, device=dev).long()[:, None] \
                + torch.arange(L, device=dev)[None, :]
            win = frames[idx]                                 # [Nw, L, S, S, 3]
            feed["video"] = win.reshape((n_win // W, W) + win.shape[1:])
        if wav is not None:
            sidx = torch.as_tensor(sample_starts, device=dev).long()[:, None] \
                + torch.arange(spw, device=dev)[None, :]
            feed["wav"] = wav[sidx].reshape(n_win // W, W, spw)
        feed["hop"] = hop
        if weights is None:
            return self.model(**feed)
        return torch.func.functional_call(self.model, weights, (), feed,
                                          strict=True)

    def _plan(self, video: Dict[str, np.ndarray]):
        mcfg = self.cfg.model
        fps = float(video.get("fps") or self.cfg.data.fps)
        hop_e, dyn, _, spw = mcfg.hop_plan(fps, self.cfg.data.fps)
        return fps, (hop_e if dyn else None), spw

    def _wav_need(self, n_frames: int, fps: float, spw: int) -> int:
        sr = self.cfg.model.mel.sample_rate
        need = int(round(n_frames / fps * sr)) + spw
        if fps != self.cfg.data.fps:
            need = -(-need // sr) * sr + spw
        return need

    def evaluate_video(self, state: Optional[TrainState],
                       video: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Sliding-window eval of one video (``labels`` and ``valid`` give
        the frame count and the scored frames; ``frames``, ``waveform``,
        ``fps`` as the model needs) with the params and BN state of
        ``eval_state(state)`` (the model's own when ``state`` is None) →
        {"pred": [n, 2] stitched, smoothed (``window.eval_smooth``) and
        clipped, "ccc_v", "ccc_a", "stats": the pooled-CCC sufficient
        statistics}."""
        return self._collect_eval(self._dispatch_eval(state, video))

    def _eval_weights(self, state: Optional[TrainState]) -> Optional[Tensors]:
        """The params and BN state ``state`` is evaluated with, on the
        device; None when they are the model's own tensors (or ``state`` is
        None): the model then runs as it is."""
        if state is None:
            return None
        st = self.eval_state(state)
        weights = {**st.params, **st.bn_state}
        own = dict(self.model.named_parameters())
        own.update(self.model.named_buffers())
        if weights.keys() == own.keys() and all(
                weights[n] is t for n, t in own.items()):
            return None
        return {n: t.to(self.device) for n, t in weights.items()}

    @torch.no_grad()
    def _dispatch_eval(self, state: Optional[TrainState],
                       video: Dict[str, np.ndarray], prep=None):
        """Prepare and upload one video (or take ``prep``, a
        ``_prepare_eval_inputs`` result: an ensemble dispatches one upload
        against k states) and enqueue its eval on the device without
        reading anything back; ``_collect_eval`` reads the result. The
        chunked eval reads each chunk's sums to the host as it goes (as the
        reference's does), so its dispatch does all the work and its collect
        only passes the result on."""
        wcfg = self.cfg.window
        weights = self._eval_weights(state)
        n = len(video["labels"])
        labels = np.asarray(video["labels"], np.float32)
        valid = np.asarray(video["valid"], bool)
        starts = window_starts(n, wcfg.window_frames, wcfg.eval_stride)
        if wcfg.eval_max_windows and len(starts) > wcfg.eval_max_windows:
            pred = self._evaluate_chunked(video, starts, weights)
            return pred, _host_ccc(pred, labels, valid), labels, valid
        if prep is None:
            prep = self._prepare_eval_inputs(video, starts)
        stitched, per_dim = self._evaluate_fused(prep, weights)
        return stitched[:n], per_dim, labels, valid

    def _collect_eval(self, pending) -> Dict[str, Any]:
        """The result of one ``_dispatch_eval``: its device tensors read
        back (waiting for the video's kernels), host arrays as they are."""
        pred, per_dim, labels, valid = (
            v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for v in pending)
        return {"pred": pred,
                "ccc_v": float(per_dim[0]), "ccc_a": float(per_dim[1]),
                "stats": ccc_sufficient_stats(pred, labels, valid)}

    def evaluate_stream(self, state: Optional[TrainState], videos,
                        pipeline: int = 2):
        """Whole-video eval over (video_id, video dict) pairs with
        ``max(pipeline, 1)`` videos in flight: video i+1 is prepared,
        uploaded and enqueued before video i is read back. Yields
        (video_id, ``evaluate_video`` result) in input order."""
        return _in_flight(videos, lambda video: self._dispatch_eval(state, video),
                          self._collect_eval, pipeline)

    def _prepare_eval_inputs(self, video, starts: np.ndarray) -> Dict[str, Any]:
        """The fused eval's host padding and its one upload: the frames
        padded to the frame bucket and the wav cut or padded to the bucketed
        length, on the device, beside the padded window starts, their sample
        offsets, the hop plan and the padded labels. Every dispatch that
        takes it reads the same device buffers."""
        wcfg, mcfg = self.cfg.window, self.cfg.model
        sr = mcfg.mel.sample_rate
        n = len(video["labels"])
        n_win = len(starts)
        n_frames_pad, n_win_pad = self.eval_buckets(n)
        starts_p = np.concatenate([starts,
                                   np.repeat(starts[-1:], n_win_pad - n_win)])
        fps, hop, spw = self._plan(video)
        frames = wav = None
        if mcfg.use_video:
            f = video["frames"]
            frames = self._to_device(
                np.pad(f, [(0, n_frames_pad - len(f))] + [(0, 0)] * 3))
        if mcfg.use_audio:
            need = self._wav_need(n_frames_pad, fps, spw)
            w = video["waveform"]
            wav = self._to_device(
                np.pad(w, (0, max(0, need - len(w))))[:need].astype(np.float32))
        labels = np.full((n_frames_pad, 2), -5.0, np.float32)
        labels[:n] = video["labels"]
        valid = np.zeros(n_frames_pad, bool)
        valid[:n] = video["valid"]
        return {"n": n, "n_win": n_win, "n_frames_pad": n_frames_pad,
                "starts": starts_p,
                "sample_starts": np.round(starts_p / fps * sr).astype(np.int32),
                "frames": frames, "wav": wav, "spw": spw, "hop": hop,
                "labels": self._to_device(labels),
                "valid": self._to_device(valid)}

    def _evaluate_fused(self, prep: Dict[str, Any],
                        weights: Optional[Tensors] = None):
        """→ (stitched [n_frames_pad, 2], per-dim CCC over the padded
        timeline in fp32), both on the device and not read back, as the
        reference's fused eval."""
        wcfg, mcfg = self.cfg.window, self.cfg.model
        L = wcfg.window_frames
        n, n_win, n_frames_pad = prep["n"], prep["n_win"], prep["n_frames_pad"]
        starts_p = prep["starts"]
        n_win_pad = len(starts_p)
        preds = self._windowed_forward(starts_p, prep["sample_starts"],
                                       prep["frames"], prep["wav"],
                                       prep["spw"], prep["hop"], weights)
        st = self._to_device(starts_p)
        win_valid = torch.arange(n_win_pad, device=self.device) < n_win
        if mcfg.per_frame:
            stitched = stitch_framewise(preds.reshape(n_win_pad, L, -1), st,
                                        n_frames_pad, win_valid)
        else:
            m = coverage_matrix(st, n_frames_pad, L) * win_valid[None, :].float()
            num = m @ preds.reshape(n_win_pad, -1).float()
            stitched = num / torch.clamp_min(m.sum(1, keepdim=True), 1.0)
        if wcfg.eval_smooth > 1:
            # edge-extend the last real frame over the bucket padding so the
            # smoother sees the host smoother's edge padding, not zeros
            fidx = torch.arange(n_frames_pad, device=self.device)
            last = stitched[max(n - 1, 0)]
            stitched = smooth_moving_average(
                torch.where((fidx < n)[:, None], stitched, last[None, :]),
                wcfg.eval_smooth)
        stitched = torch.clamp(stitched, -1.0, 1.0)
        per_dim = ccc(stitched, prep["labels"], mask=prep["valid"][:, None],
                      axis=(0,))
        return stitched, per_dim

    def _evaluate_chunked(self, video, starts: np.ndarray,
                          weights: Optional[Tensors] = None) -> np.ndarray:
        """Bounded window chunks with fixed geometry; partial stitch sums
        accumulate on the host (summation is associative where per-chunk
        averages are not)."""
        wcfg, mcfg = self.cfg.window, self.cfg.model
        L = wcfg.window_frames
        sr = mcfg.mel.sample_rate
        fps, hop, spw = self._plan(video)
        n = len(video["labels"])
        wb = self._win_bucket()
        M = -(-wcfg.eval_max_windows // wb) * wb
        span = (M - 1) * wcfg.eval_stride + L
        local_nf = -(-span // 256) * 256 + L
        need_wav = self._wav_need(local_nf, fps, spw)
        frames = video.get("frames") if mcfg.use_video else None
        wav = video.get("waveform") if mcfg.use_audio else None
        num = np.zeros((n + local_nf, 2), np.float32)
        den = np.zeros((n + local_nf,), np.float32)
        for i0 in range(0, len(starts), M):
            sub = starts[i0:i0 + M]
            f0 = int(sub[0])
            sub_p = np.concatenate([sub, np.repeat(sub[-1:], M - len(sub))])
            fr = wv = None
            if frames is not None:
                seg = frames[f0:f0 + local_nf]
                fr = self._to_device(
                    np.pad(seg, [(0, local_nf - len(seg))] + [(0, 0)] * 3))
            w0 = 0
            if wav is not None:
                w0 = int(np.round(f0 / fps * sr))
                seg = wav[w0:w0 + need_wav]
                wv = self._to_device(
                    np.pad(seg, (0, need_wav - len(seg))).astype(np.float32))
            sstarts = (np.round(sub_p / fps * sr) - w0).astype(np.int32)
            local = (sub_p - f0).astype(np.int32)
            preds = self._windowed_forward(local, sstarts, fr, wv, spw, hop,
                                           weights)
            valid = torch.arange(M, device=self.device) < len(sub)
            st = self._to_device(local)
            if mcfg.per_frame:
                pn, pd = stitch_framewise_sums(preds.reshape(M, L, -1), st,
                                               local_nf, valid)
            else:
                m = coverage_matrix(st, local_nf, L) * valid[None, :].float()
                pn, pd = m @ preds.reshape(M, -1).float(), m.sum(1)
            num[f0:f0 + local_nf] += pn.cpu().numpy()
            den[f0:f0 + local_nf] += pd.cpu().numpy()
        stitched = num[:n] / np.maximum(den[:n, None], 1.0)
        if wcfg.eval_smooth > 1:
            # imported here: m3f_torch.infer imports this module
            from m3f_torch.infer.submission import smooth_predictions
            stitched = smooth_predictions(stitched, wcfg.eval_smooth)
        return np.clip(stitched, -1.0, 1.0)

    def evaluate(self, state: Optional[TrainState], dataset, max_videos: int = 0,
                 pipeline: int = 2, per_video_fn=None) -> Dict[str, float]:
        """Split-level CCC in both conventions: ``ccc_v/ccc_a/ccc_mean``
        (mean of per-video CCCs) and ``pooled_ccc_*`` (one CCC over all
        videos' valid frames, from fp64 sufficient statistics);
        ``ccc_select`` is the one ``train.eval_ccc_convention`` picks.
        ``dataset`` has ``video_ids()`` and ``load_video(id)``; ``pipeline``
        videos are in flight (``evaluate_stream``)."""
        ids = dataset.video_ids()
        if max_videos:
            ids = ids[:max_videos]
        if not ids:
            raise ValueError(
                "evaluate(): the validation split has no videos — check "
                "data.root / annotation layout (empty Validation_Set?)")
        videos = ((vid, dataset.load_video(vid)) for vid in ids)
        return self._aggregate_eval(
            self.evaluate_stream(state, videos, pipeline=pipeline),
            per_video_fn)

    def _aggregate_eval(self, results, per_video_fn=None) -> Dict[str, float]:
        """(video_id, evaluate_video result) pairs → the metric dict."""
        vs, as_ = [], []
        pooled = np.zeros((2, 6), np.float64)
        for vid, r in results:
            if per_video_fn is not None:
                per_video_fn(vid, r)
            vs.append(r["ccc_v"])
            as_.append(r["ccc_a"])
            pooled += r["stats"]
        pc = ccc_from_stats(pooled)
        out = {"ccc_v": float(np.mean(vs)), "ccc_a": float(np.mean(as_)),
               "ccc_mean": float((np.mean(vs) + np.mean(as_)) / 2),
               "pooled_ccc_v": float(pc[0]), "pooled_ccc_a": float(pc[1]),
               "pooled_ccc_mean": float(pc.mean())}
        out["ccc_select"] = (out["pooled_ccc_mean"]
                             if self.cfg.train.eval_ccc_convention == "pooled"
                             else out["ccc_mean"])
        return out

    # -- ensembles ------------------------------------------------------------

    def evaluate_ensemble(self, states: List[TrainState], dataset,
                          max_videos: int = 0,
                          per_video_fn=None) -> Dict[str, float]:
        """``evaluate``'s metrics (plus ``n_models``) of the prediction-level
        ensemble of ``states``: each video's per-frame mean track of the k
        states, scored in both CCC conventions. Each video is uploaded
        once, and its k evals are dispatched before the first is read back
        (``_ensemble_stream``). Members should be ``commit_state(...,
        eval_only=True)`` snapshots."""
        if not states:
            raise ValueError("evaluate_ensemble() needs at least one state")
        ids = dataset.video_ids()
        if max_videos:
            ids = ids[:max_videos]
        if not ids:
            raise ValueError(
                "evaluate_ensemble(): the split has no videos — check "
                "data.root / annotation layout")
        videos = ((vid, dataset.load_video(vid)) for vid in ids)
        out = self._aggregate_eval(self._ensemble_stream(states, videos),
                                   per_video_fn)
        out["n_models"] = len(states)
        return out

    def _ensemble_stream(self, states: List[TrainState], videos,
                         pipeline: int = 2):
        """``evaluate_stream``'s loop with k states a video: video i+1 is
        uploaded and its k evals enqueued before video i is read back.
        Yields (video_id, result) with the mean track's CCC and pooled
        statistics, as ``_collect_eval``'s."""
        def dispatch(video):
            return (np.asarray(video["labels"], np.float32),
                    np.asarray(video["valid"], bool),
                    self._dispatch_eval_multi(states, video))

        def collect(item):
            labels, valid, pending = item
            pred = _mean_track([self._collect_eval(p)["pred"] for p in pending])
            per_dim = _host_ccc(pred, labels, valid)
            return {"pred": pred,
                    "ccc_v": float(per_dim[0]), "ccc_a": float(per_dim[1]),
                    "stats": ccc_sufficient_stats(pred, labels, valid)}
        return _in_flight(videos, dispatch, collect, pipeline)

    def _dispatch_eval_multi(self, states: List[TrainState], video):
        """One video's eval against k states, enqueued without a read back:
        a fused video's one upload (``_prepare_eval_inputs``) is shared by
        the k dispatches; a video over ``window.eval_max_windows`` takes the
        chunked path once per state."""
        wcfg = self.cfg.window
        starts = window_starts(len(video["labels"]), wcfg.window_frames,
                               wcfg.eval_stride)
        if wcfg.eval_max_windows and len(starts) > wcfg.eval_max_windows:
            return [self._dispatch_eval(st, video) for st in states]
        prep = self._prepare_eval_inputs(video, starts)
        return [self._dispatch_eval(st, video, prep=prep) for st in states]

    def predict_ensemble(self, states: List[TrainState],
                         video) -> np.ndarray:
        """[N, 2] per-frame mean (float64, cast to float32) of the stitched
        predictions of ``states`` on one video; the k evals are enqueued
        before the first is read back."""
        if not states:
            raise ValueError("predict_ensemble() needs at least one state")
        pending = self._dispatch_eval_multi(states, video)
        return _mean_track([self._collect_eval(p)["pred"] for p in pending])

    # -- fit ------------------------------------------------------------------

    def fit(self, train_stream, val_dataset=None,
            num_steps: Optional[int] = None,
            log: Callable[[str], None] = print,
            checkpointer=None, metric_writer=None, *,
            keep_weights: bool = False) -> Tuple[TrainState, Dict]:
        """Train for ``num_steps`` (default ``train.num_steps``) optimizer
        steps, from the seeded init (every call starts over from
        ``train.seed``) or, with ``keep_weights=True``, from the weights the
        caller loaded into ``Trainer.model``; a checkpoint restore wins over
        both. ``train_stream`` is a batch iterator or a callable
        ``factory(skip_batches) -> iterator``, called after the checkpoint
        restore with the restored step, so a resumed run consumes exactly
        the batches an uninterrupted one would. Logs, evaluates (with
        early stop and plateau decays) and checkpoints at the configured
        cadences; ``metric_writer`` (``utils/logging.MetricWriter``) gets
        the reference's rows: ``loss``, ``grad_norm`` and ``clips_per_sec``
        at each log step, ``eval_<key>`` at each eval. Returns (state,
        history): ``loss`` and ``grad_norm`` at each log step, ``eval``
        results at each eval."""
        tcfg = self.cfg.train
        num_steps = num_steps or tcfg.num_steps
        state = self.init_state(keep_weights=keep_weights)
        if checkpointer is not None:
            state = checkpointer.maybe_restore(state, self)
        history: Dict[str, List] = {"loss": [], "grad_norm": []}
        best = BestTracker(tcfg.early_stop_patience, tcfg.min_delta)
        ocfg = tcfg.optim
        # torch ReduceLROnPlateau semantics: decay on the (patience+1)-th
        # consecutive bad eval; the multiplier itself lives in the state
        plateau = (BestTracker(ocfg.plateau_patience + 1, tcfg.min_delta)
                   if ocfg.schedule == "plateau" else None)
        t0, seen = time.time(), 0
        use_a, use_v = self.cfg.model.use_audio, self.cfg.model.use_video
        start_step = state.step
        owns_stream = (callable(train_stream)
                       and not hasattr(train_stream, "__next__"))
        if owns_stream:
            train_stream = train_stream(start_step)
        # a trace of steps start+2 to start+12: the first two build the
        # kernels and warm the allocator
        with contextlib.ExitStack() as profiling:
            for i in range(start_step, num_steps):
                if tcfg.profile_dir and i == start_step + 2:
                    profiling.enter_context(trace(tcfg.profile_dir))
                host_batch = next(train_stream)
                feed = {"labels": host_batch["labels"], "mask": host_batch["mask"]}
                if use_v:
                    feed["video"] = host_batch["video"]
                if use_a:
                    feed["wav"] = host_batch["wav"]
                    if "hop" in host_batch:
                        feed["hop"] = host_batch["hop"]
                metrics = self.train_step(state, feed)
                seen += host_batch["labels"].shape[0] * host_batch["labels"].shape[1]
                if i == start_step + 12:
                    profiling.close()
                if (tcfg.log_every > 0 and (i + 1) % tcfg.log_every == 0) \
                        or i + 1 == num_steps:
                    loss = float(metrics["loss"])
                    gnorm = float(metrics["grad_norm"])
                    dt = time.time() - t0
                    history["loss"].append(loss)
                    history["grad_norm"].append(gnorm)
                    log(f"step {i+1}/{num_steps} loss={loss:.4f} "
                        f"batch_ccc={float(metrics['batch_ccc']):.4f} "
                        f"clips/s={seen / dt:.1f}")
                    if metric_writer is not None:
                        metric_writer.write(i + 1, {
                            "loss": loss, "grad_norm": gnorm,
                            "clips_per_sec": seen / dt})
                    t0, seen = time.time(), 0
                if (val_dataset is not None and tcfg.eval_every > 0
                        and (i + 1) % tcfg.eval_every == 0):
                    ev = self.evaluate(state, dataset=val_dataset)
                    log(f"  eval @{i+1}: ccc_v={ev['ccc_v']:.4f} "
                        f"ccc_a={ev['ccc_a']:.4f} "
                        f"pooled_v={ev['pooled_ccc_v']:.4f} "
                        f"pooled_a={ev['pooled_ccc_a']:.4f}")
                    history.setdefault("eval", []).append(ev)
                    if metric_writer is not None:
                        metric_writer.write(i + 1, {f"eval_{k}": v
                                                    for k, v in ev.items()})
                    if plateau is not None:
                        _, hit = plateau.update(ev["ccc_select"], i + 1)
                        if hit:
                            cur = float(state.lr_mult)
                            new = max(cur * ocfg.plateau_factor,
                                      ocfg.plateau_min_scale)
                            if new < cur:
                                state.lr_mult = float(np.float32(new))
                                log(f"  plateau @{i+1}: no "
                                    f"{tcfg.eval_ccc_convention} CCC improvement "
                                    f"for {plateau.bad_evals} evals — lr x "
                                    f"{ocfg.plateau_factor:g} (mult {new:.2e})")
                            plateau.bad_evals = 0
                    is_best, should_stop = best.update(ev["ccc_select"], i + 1)
                    if is_best and checkpointer is not None:
                        checkpointer.save_best(state, ev["ccc_select"])
                    if should_stop:
                        log(f"early stop @{i+1}: no ccc_mean improvement for "
                            f"{best.bad_evals} evals (best {best.best:.4f} "
                            f"@step {best.best_step})")
                        break
                if (checkpointer is not None and tcfg.checkpoint_every > 0
                        and (i + 1) % tcfg.checkpoint_every == 0):
                    checkpointer.save_async(state)
        if owns_stream and hasattr(train_stream, "close"):
            train_stream.close()
        if checkpointer is not None:
            checkpointer.wait()
        return state, history
