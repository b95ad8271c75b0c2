"""Typed configuration system.

The port's own copy of ``m3f/pytorch_tpu/config.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_config.py`` holds the two
equal: every preset's fields and hash, overrides, and the hop plan.

The reference uses argparse hyperparameters attached to a LightningModule
(SURVEY.md §5 "Config / flag system", reconstructed — reference mount was
empty).  Here every hyperparameter is a frozen dataclass field so a config is
hashable, printable, diffable, and can be embedded into checkpoints.

Constants whose exact reference value could not be read are marked
``# UNVERIFIED vs reference`` — they are pinned here, in exactly one place, so
they can be corrected once if the reference mount ever appears
(SURVEY.md §7 "Hard parts").

The five preset factory functions at the bottom map 1:1 to
BASELINE.json:6-12 ("configs").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Tuple

# Label value used by Aff-Wild2 annotations for invalid / non-annotated frames.
INVALID_LABEL = -5.0  # UNVERIFIED vs reference (paper convention: labels in [-1,1], -5 = invalid)

# Plausible-frame-rate band shared by the dataset's fps derivation and the
# serving-side request validator (one definition so they cannot drift).
FPS_BAND = (5.0, 120.0)


@dataclass(frozen=True)
class MelConfig:
    """Fused on-device log-mel frontend (replaces offline librosa pass, SURVEY §3.1)."""

    sample_rate: int = 16_000        # ffmpeg -ar 16000 -ac 1 (SURVEY §2.1 C3)
    n_fft: int = 1024                # UNVERIFIED vs reference
    win_length: int = 1024           # UNVERIFIED vs reference
    hop_length: int = 533            # 16000 / 30fps ≈ 533 → ~1 mel frame per video frame. UNVERIFIED vs reference
    n_mels: int = 64                 # UNVERIFIED vs reference (BASELINE "log-mel", paper-family default)
    fmin: float = 0.0
    fmax: float = 8000.0             # Nyquist at 16 kHz
    mel_scale: str = "slaney"        # librosa default; UNVERIFIED vs reference
    norm: str = "slaney"             # area-normalize filters; UNVERIFIED vs reference
    log_eps: float = 1e-6            # log(power + eps)
    center: bool = True              # librosa-style reflect-pad framing
    # Largest per-video hop the DYNAMIC-hop paths size their static wav
    # buffers for: hop at the 24 fps film floor (round(16000/24) ≈ 667).
    # The reference's per-video mel precompute chose hop from each video's
    # actual rate (SURVEY §2.1 C3 "hop aligned ... with video frames");
    # here hop_for_fps() reproduces that per window, and videos slower than
    # the floor clamp to it (bounded residual warp instead of an unbounded
    # buffer). UNVERIFIED vs reference.
    max_hop_length: int = 667

    @property
    def mel_frames_per_video_frame(self) -> float:
        return self.sample_rate / 30.0 / self.hop_length

    def hop_for_fps(self, fps: float, nominal_fps: float = 30.0) -> int:
        """Per-video mel hop: one mel frame per video frame at the video's
        TRUE rate (VERDICT r4 missing #1 — a fixed hop feeds every window a
        constant ~0.5 s of audio, nearest-upsampled onto 16 video frames
        with a time-warp growing to ~1/5 of the window at 25 fps).

        The nominal rate keeps the CONFIGURED hop_length (it is pinned
        `# UNVERIFIED vs reference` and must stay user-correctable in one
        place); off-rate videos get round(sample_rate / fps), clamped to
        max_hop_length so static buffers stay bounded."""
        if fps == nominal_fps:
            return self.hop_length
        return min(int(round(self.sample_rate / fps)), self.max_hop_length)


@dataclass(frozen=True)
class AudioNetConfig:
    """2D CNN over log-mel patches (SURVEY §2.1 C5)."""

    channels: Tuple[int, ...] = (32, 64, 128, 256)  # UNVERIFIED vs reference
    feature_dim: int = 256                          # output feature per window
    norm: str = "batch"                             # batchnorm like the torch repo family
    mel_frames_per_window: int = 16                 # mel frames consumed per 16-frame video window
    bn_two_pass: bool = False                       # torch-order BN variance (see nn.BatchNorm)


@dataclass(frozen=True)
class VisualNetConfig:
    """R(2+1)D-style 3D CNN over 16x112x112 face clips (SURVEY §2.1 C4, §3.4)."""

    block_channels: Tuple[int, ...] = (64, 128, 256, 512)  # R(2+1)D-18 recipe
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)       # depth-18. UNVERIFIED vs reference (18 vs 34)
    stem_channels: int = 64
    feature_dim: int = 512
    frames: int = 16
    size: int = 112
    # "pallas_fused" routes every stride-1 block conv through the fused
    # affine+relu→conv→stats Pallas unit (ops/pallas/conv_bn.py) — identical
    # math and parameters, the BN reductions ride the conv kernels. "xla" is
    # the plain composition (strided blocks and the stem always use it).
    conv_backend: str = "xla"
    # Squeeze-excitation side branch per block (SURVEY §3.4 "2D-SE side
    # branch — must be re-verified"): 0 = off (torchvision recipe, the
    # default), >0 = SE channel-reduction ratio (16 is the SE-Net default).
    # SE blocks always use the XLA conv path.
    se_ratio: int = 0
    # (2+1)D factorization width: "flops" = torchvision's FLOP-matched
    # formula (the default — torch-checkpoint-compatible), "lane" = round
    # each midplane count to the nearest multiple of 128 so stage tensors
    # fill whole TPU lane tiles (144→128, 230→256, 576→512, ...). A
    # TPU-native capacity-similar variant — NOT torch-checkpoint-compatible.
    mid_mode: str = "flops"
    # Backbone conv family — the torchvision video/resnet.py trio (SURVEY
    # §2.1 C4 pins only "R(2+1)D/3D-ResNet-style", so all three are
    # supported and checkpoint-compatible): "2plus1d" (r2plus1d_18, the
    # default), "3d" (r3d_18: 3x3x3 convs + (3,7,7) stem), "mc3" (mc3_18:
    # 3d stage 1, (1,3,3) no-temporal stages 2-4, spatial-only downsample).
    conv_mode: str = "2plus1d"
    bn_two_pass: bool = False  # torch-order BN variance (see nn.BatchNorm)
    # Space-to-depth stem (the classic TPU input-conv rewrite, e.g. MLPerf
    # ResNet): the stride-(1,2,2) 7x7 stem conv over C_in=3 is re-expressed as
    # a stride-1 4x4 conv over 2x2-packed input with C_in=12 — EXACT same
    # math (the kernel is zero-padded 7→8 and re-tiled at trace time from the
    # canonical checkpoint-layout parameters), so torch checkpoint
    # compatibility is unaffected. Pure backend knob, excluded from the
    # semantic config hash. Measured impact in BASELINE.md.
    stem_s2d: bool = False


@dataclass(frozen=True)
class GRUConfig:
    """Bidirectional GRU temporal-fusion head (SURVEY §2.1 C6)."""

    hidden_size: int = 256   # UNVERIFIED vs reference
    num_layers: int = 1      # UNVERIFIED vs reference
    bidirectional: bool = True
    backend: str = "xla"     # "xla" lax.scan | "pallas" VMEM-resident kernel


@dataclass(frozen=True)
class ModelConfig:
    use_audio: bool = True
    use_video: bool = True
    mel: MelConfig = field(default_factory=MelConfig)
    audio: AudioNetConfig = field(default_factory=AudioNetConfig)
    visual: VisualNetConfig = field(default_factory=VisualNetConfig)
    gru: GRUConfig = field(default_factory=GRUConfig)
    num_outputs: int = 2     # (valence, arousal)
    head_activation: str = "tanh"  # predictions live in [-1, 1]
    # Per-FRAME predictions (the reference's actual granularity: the dataset
    # yields per-frame [T,2] labels and eval stitches onto the frame timeline,
    # SURVEY §1 L2 / §2.1 C9). True → branch features keep their temporal
    # axis, the BiGRU runs over frames, the head emits [B, W, L, 2].
    # False → one (V,A) per 16-frame window (round-1 behavior, kept for
    # ablation). No parameter shapes change between the two modes, so torch
    # checkpoint compatibility is identical.
    per_frame: bool = True
    # Train-time dropout rate on the fused features (before the BiGRU) and
    # on the BiGRU output (before the head) — the reference repo family's
    # usual placement. 0 = off. UNVERIFIED vs reference.
    dropout: float = 0.0
    # Output frames per window when no video input pins it (audio-only
    # per-frame mode); with video present L is taken from the input shape.
    frames_per_window: int = 16
    # Pretrained init (reference loads IG-65M/Kinetics state_dicts at model
    # __init__, SURVEY §3.5): path to an .npz written by
    # scripts/import_torch_checkpoint.py ({params, state} layout, kind in its
    # meta). Branch kinds (r2plus1d / audio_cnn) load that branch only and
    # leave the rest of the model freshly initialized; kind=m3f loads all.
    init_from: str = ""
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mel_backend: str = "xla"  # "xla" (rfft) | "pallas" (fused DFT kernel)

    @property
    def fused_dim(self) -> int:
        d = 0
        if self.use_audio:
            d += self.audio.feature_dim
        if self.use_video:
            d += self.visual.feature_dim
        return d

    def hop_plan(self, fps: float, nominal_fps: float
                 ) -> Tuple[int, bool, int, int]:
        """Per-video mel-hop plan for a video/session at ``fps`` — THE single
        derivation every consumer (train windowing, both eval dispatches,
        streaming sessions, warmup rate filters) goes through.

        Returns ``(hop, dynamic, spw, spw_buf)``: the per-window mel hop,
        whether the dynamic-hop program is engaged (hop differs from the
        nominal ``mel.hop_length``), the window's REAL audio span in samples
        ((mel_frames−1)·hop), and the static wav-buffer width the compiled
        program is shaped for (max-hop-sized when dynamic so every rate
        shares ONE program; == spw otherwise).

        ``mel_backend='pallas'`` frames at a compile-time stride, so the
        dynamic hop is unavailable there: the plan falls back to the fixed
        nominal hop (the bounded-warp pre-dynamic-hop behavior) instead of
        letting the model raise at trace time — a pallas run over off-rate
        data must keep working, just without the per-video time base.
        Audio-less models trivially plan the fixed hop (nothing reads it).
        """
        frames = self.audio.mel_frames_per_window
        hop = self.mel.hop_for_fps(fps, nominal_fps)
        if not self.use_audio or self.mel_backend == "pallas":
            hop = self.mel.hop_length
        dynamic = hop != self.mel.hop_length
        spw = (frames - 1) * hop
        buf = (frames - 1) * self.mel.max_hop_length if dynamic else spw
        return hop, dynamic, spw, buf


@dataclass(frozen=True)
class WindowConfig:
    """Clip windowing for training and sliding-window eval (SURVEY §2.1 C2/C9, [B:10])."""

    window_frames: int = 16
    train_stride: int = 16    # non-overlapping windows during training. UNVERIFIED vs reference
    eval_stride: int = 8      # overlap-stitched eval. UNVERIFIED vs reference
    windows_per_clip: int = 4  # consecutive windows fed to the BiGRU as one sequence
    # Eval-time prediction smoothing: centered moving-average window (frames)
    # applied on device before clip + CCC — the reference's submission
    # postprocess smoother (infer/submission.py), surfaced at eval so val CCC
    # measures what the server would score. 1 = off. Postprocess-only knob,
    # excluded from the semantic config hash.
    eval_smooth: int = 1
    # Upper bound on windows per whole-video eval dispatch. Videos whose
    # sliding-window enumeration exceeds it are evaluated in CHUNKS of this
    # many windows (partial stitch sums accumulate on host — bounded device
    # memory for arbitrarily long videos; real ABAW videos run many minutes
    # at 30 fps). 0 = always one fused call. Rounded up to the mesh's
    # sequence-bucket granularity. Backend knob, excluded from the semantic
    # config hash.
    eval_max_windows: int = 512


@dataclass(frozen=True)
class DataConfig:
    root: str = ""            # Aff-Wild2 root (cropped_aligned + annotations + audio)
    fps: float = 30.0
    image_size: int = 112
    synthetic: bool = True    # fall back to synthetic data when no dataset is present
    synthetic_num_videos: int = 8
    synthetic_video_frames: int = 128
    num_workers: int = 4
    prefetch: int = 2
    shuffle_buffer: int = 256   # cross-video example mixing (0 = off)
    # Decode-cache capacity of the train stream in whole videos (see
    # data/windowing.example_stream). 1 = decode each video once per epoch
    # (safe anywhere); RAM-rich hosts raise it to keep decoded videos
    # across epochs. Host-memory/CPU trade only — batches are identical.
    cache_videos: int = 1
    # When per-video fps falls back to annotation-rows/wav-duration (no
    # container to probe), a wav may outlast the video by up to this many
    # seconds of trailing audio (AAC decoder padding adds tens of ms to
    # every ffmpeg-extracted wav; an audio stream running past the last
    # frame adds more) WITHOUT reading as an off-rate video: the derivation
    # resolves the duration against canonical rates under this tail
    # allowance (AffWild2Dataset._resolve_wav_fps). The default covers the
    # routine ffmpeg/AAC tail (~50 ms) with 3x margin; genuinely off-rate
    # videos (25 vs 30; NTSC 29.97 past ~2.5 min) mismatch by more and
    # keep their own clock. Set ~0.03 if your wavs are sample-exact.
    fps_tail_tolerance_s: float = 0.15
    # On-device train-time augmentation (ops/augment.py) — runs inside the
    # jitted step on the uint8 batch (zero extra host work / H2D bytes).
    # UNVERIFIED vs reference; standard for the task, off by default.
    augment: bool = False
    aug_flip_prob: float = 0.5
    aug_brightness: float = 0.1
    aug_contrast: float = 0.1


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"       # UNVERIFIED vs reference
    learning_rate: float = 1e-4   # UNVERIFIED vs reference
    weight_decay: float = 0.0
    grad_clip_norm: float = 5.0
    warmup_steps: int = 0
    schedule: str = "constant"    # "constant" | "cosine" | "step" | "plateau"
    step_decay_factor: float = 0.1   # "step": lr ×= factor at each boundary
    step_decay_every: int = 0        # "step": boundary spacing (0 → num_steps/3)
    # "plateau": torch ReduceLROnPlateau on the eval selection metric
    # (train.eval_ccc_convention). TPU-native mechanism: the multiplier is a
    # replicated fp32 scalar in TrainState (checkpointed, exact-resume) that
    # post-scales the optimizer update INSIDE the one jitted train step, so
    # a decay never recompiles; fit() decides decays host-side at eval
    # boundaries (train/loop.py). Requires eval-during-training — with
    # eval_every=0 the multiplier simply never moves.
    plateau_factor: float = 0.1      # lr_mult ×= factor after a plateau
    plateau_patience: int = 2        # torch semantics: IGNORE this many bad
    #                                  evals, decay on the next one
    plateau_min_scale: float = 1e-3  # lr_mult floor (no further decays)
    accumulate_steps: int = 1     # optax.MultiSteps (SURVEY §2.3)
    # Fine-tuning controls for pretrained-backbone runs (the reference loads
    # IG-65M/Kinetics backbones at model __init__, SURVEY §3.5; torch users
    # freeze or down-weight them via param groups — this is the pytree
    # equivalent, addressed by checkpoint-path prefixes like "visual" or
    # "visual/stem"; see train/checkpoint.py path convention).
    #   freeze:   comma-separated path prefixes whose params receive exactly
    #             zero updates (weight decay included); params stay bitwise
    #             at their init/pretrained values.
    #   lr_scale: comma-separated "prefix=factor" pairs; the final optimizer
    #             update for matching params is multiplied by factor — for
    #             adam/adamw/sgd this is exactly a per-group learning rate
    #             (moments are lr-independent). Prefixes must not overlap.
    # Unknown prefixes (matching no param) fail loudly at trainer init.
    freeze: str = ""
    lr_scale: str = ""


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding layer — the rebuild's entire 'distributed backend'
    (SURVEY §2.4 C-P1)."""

    data_axis: str = "data"
    model_axis: str = "model"   # tensor parallelism: BiGRU gates, fusion head
    num_data: int = -1          # -1 = all available devices
    num_model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8           # global batch of window-sequences
    num_steps: int = 1000
    eval_every: int = 200
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/m3f_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
    log_every: int = 50
    # Early stopping on eval ccc_mean (reference C8 Lightning callbacks,
    # SURVEY §2.1): stop after this many evals without improvement (0 = off).
    early_stop_patience: int = 0
    min_delta: float = 0.0        # improvement threshold for best/early-stop
    profile_dir: str = ""         # non-empty → jax.profiler trace around steps
    debug_nans: bool = False      # jax_debug_nans during development (SURVEY §5)
    loss: str = "ccc"             # "ccc" | "mse" | "ccc+mse" (SURVEY §2.1 C7)
    mse_weight: float = 1.0       # weight of the MSE term in "ccc+mse"
    # CCC-loss moment computation: "two_pass" (subtract-the-mean, the torch
    # golden's order) | "one_pass" (sufficient statistics — identical math;
    # the reference chose it for its program-load behaviour on its own
    # backend, see m3f/pytorch_tpu/ops/ccc.py). Excluded from the semantic
    # config hash.
    ccc_stats: str = "two_pass"
    # Validation CCC convention driving best-checkpoint selection and early
    # stopping: "per_video" (mean of per-video CCCs, the historical default)
    # | "pooled" (one CCC over the concatenation of all videos' valid
    # frames, ABAW-style). evaluate() always REPORTS both; this only picks
    # the selection metric. Excluded from the semantic config hash (a
    # reporting/selection knob, not resumed-state semantics).
    eval_ccc_convention: str = "per_video"
    # Exponential moving average of the params, updated every step
    # (shadow ← shadow·d + params·(1−d); 0 = off). When enabled, eval and
    # best-checkpoint selection use the EMA shadow — serving-quality weights
    # at no extra training cost (complements scripts/average_checkpoints.py,
    # which averages discrete checkpoints after the fact).
    ema_decay: float = 0.0
    # Ramp the decay in early training: d_t = min(ema_decay, (1+t)/(10+t)).
    # A cold 0.999 shadow stays ~frozen at init for the first ~1k steps
    # (measured: 300-step soak evaluated the shadow far behind the online
    # weights); the ramp makes the shadow an honest running average from
    # step 1 and converges to ema_decay. Set False for the textbook
    # constant-decay EMA.
    ema_ramp: bool = True
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "m3f"
    model: ModelConfig = field(default_factory=ModelConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def config_hash(self) -> str:
        """Stable hash logged into checkpoints (SURVEY §5).

        Covers what makes RESUMED STATE wrong — model architecture, input
        semantics (image size, fps alignment), window geometry, optimizer
        structure, loss choice — and deliberately excludes run cadence,
        placement, and pure backend knobs (num_steps, batch size, eval /
        checkpoint / log intervals, paths, mesh, xla-vs-pallas selections,
        init_from): extending a run, changing batch size, flipping a kernel
        backend with identical math, or moving files are legitimate resumes,
        and a false abort there teaches users to delete the safety check.
        """
        model = dataclasses.asdict(self.model)
        # backend knobs are documented identical-math alternatives, and
        # init_from is a file path consumed once at init (a resume checkpoint
        # wins over it anyway)
        model.pop("mel_backend", None)
        model.pop("init_from", None)
        # buffer-sizing bound for the dynamic-hop paths: like the data
        # layer's fps derivation knobs it shapes which audio samples feed
        # OFF-RATE videos, not resumed-state layout; hashing it would break
        # every pre-existing checkpoint for a clamp that only moves for
        # sub-24fps captures
        model["mel"].pop("max_hop_length", None)
        model["visual"].pop("conv_backend", None)
        model["visual"].pop("bn_two_pass", None)
        model["visual"].pop("stem_s2d", None)
        model["audio"].pop("bn_two_pass", None)
        model["gru"].pop("backend", None)
        window = dataclasses.asdict(self.window)
        window.pop("eval_smooth", None)  # postprocess-only, no trainable state
        window.pop("eval_max_windows", None)  # dispatch-size backend knob
        optim = dataclasses.asdict(self.train.optim)
        # conditional like ema_decay below: hashes of configs that don't use
        # fine-tuning controls stay byte-identical to pre-feature checkpoints
        # (freeze/lr_scale also change the opt_state pytree layout, so when
        # SET they must — and do — change the hash)
        if not optim["freeze"]:
            optim.pop("freeze")
        if not optim["lr_scale"]:
            optim.pop("lr_scale")
        if optim["schedule"] != "plateau":
            # plateau knobs only shape training when the schedule is
            # plateau (which itself changes the hash via "schedule" AND
            # adds the lr_mult leaf to TrainState); popping them when
            # inactive keeps pre-feature hashes byte-identical
            for k in ("plateau_factor", "plateau_patience",
                      "plateau_min_scale"):
                optim.pop(k)
        semantic = {
            "model": model,
            "window": window,
            "optim": optim,
            "loss": self.train.loss,
            # input semantics: resolution and the audio/frame alignment rate
            "image_size": self.data.image_size,
            "fps": self.data.fps,
        }
        if "mse" in self.train.loss:
            semantic["mse_weight"] = self.train.mse_weight
        if self.train.ema_decay:
            # EMA adds a params-shaped shadow to the TrainState — toggling
            # it across a resume is a layout change, not a legal resume.
            # Conditional so hashes of EMA-off configs stay byte-identical.
            semantic["ema_decay"] = self.train.ema_decay
            semantic["ema_ramp"] = self.train.ema_ramp
        return hashlib.sha256(
            json.dumps(semantic, sort_keys=True).encode()
        ).hexdigest()[:16]

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _coerce_scalar(v):
    """Best-effort int → float → as-is coercion for untyped tuple elements
    (the current tuple is empty, so there is no element type to copy)."""
    if not isinstance(v, str):
        return v
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def _replace_nested(cfg: Any, dotted: str, value: Any) -> Any:
    """Replace `a.b.c` in a nested frozen-dataclass tree."""
    head, _, rest = dotted.partition(".")
    if not rest:
        f = {f.name: f for f in dataclasses.fields(cfg)}[head]
        current = getattr(cfg, head)
        if isinstance(current, tuple) and value is not None and not isinstance(value, dict):
            # tuple fields (e.g. visual.blocks_per_stage=[3,4,6,3] for the
            # R(2+1)D-34 recipe): accept JSON lists and "3,4,6,3" strings,
            # coercing elements to the existing element type
            if isinstance(value, str):
                value = [p for p in value.split(",") if p != ""]
            elif not isinstance(value, (list, tuple)):
                raise ValueError(
                    f"override '{dotted}' needs a list for tuple field "
                    f"{head} (e.g. {head}=[3,4,6,3] or {head}=3,4,6,3), "
                    f"got {value!r}")
            elem = type(current[0]) if current else None
            value = tuple(elem(v) if elem is not None else _coerce_scalar(v)
                          for v in value)
        elif value is not None and f.type not in (Any,) and not isinstance(value, (dict, list, tuple)):
            # best-effort scalar coercion from CLI strings
            if isinstance(current, bool):
                value = value if isinstance(value, bool) else str(value).lower() in ("1", "true", "yes")
            elif isinstance(current, int) and not isinstance(value, bool):
                value = int(value)
            elif isinstance(current, float):
                value = float(value)
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(cfg, **{head: _replace_nested(getattr(cfg, head), rest, value)})


def apply_overrides(cfg: ExperimentConfig, overrides: dict) -> ExperimentConfig:
    """Apply `{"train.optim.learning_rate": 3e-4, ...}` CLI-style overrides."""
    for k, v in overrides.items():
        cfg = _replace_nested(cfg, k, v)
    return cfg


# ---------------------------------------------------------------------------
# The five BASELINE.json configs ([B:7-11])
# ---------------------------------------------------------------------------

def audio_only() -> ExperimentConfig:
    """Config 1: log-mel + CNN-GRU V-A regression, CPU-runnable [B:7]."""
    return ExperimentConfig(
        name="audio_only",
        model=ModelConfig(use_audio=True, use_video=False),
        # one_pass CCC: identical math (oracle-tested); the reference's
        # starter preset ships with it because the two-pass graph triggered
        # a program-load pathology on its own backend.
        train=TrainConfig(batch_size=4, num_steps=200, ccc_stats="one_pass"),
    )


def visual_only() -> ExperimentConfig:
    """Config 2: 16-frame face-crop window through 3D backbone to V-A head [B:8]."""
    return ExperimentConfig(
        name="visual_only",
        model=ModelConfig(use_audio=False, use_video=True),
    )


def fusion() -> ExperimentConfig:
    """Config 3: audio+video late fusion with BiGRU over 16-frame windows [B:9]."""
    return ExperimentConfig(name="fusion")


def longseq_eval() -> ExperimentConfig:
    """Config 4: sliding-window full-video eval with overlap stitching [B:10]."""
    return ExperimentConfig(
        name="longseq_eval",
        window=WindowConfig(eval_stride=8, windows_per_clip=8),
    )


def distributed_train() -> ExperimentConfig:
    """Config 5: CCC-loss A/V training on sharded clips across a v5e slice [B:11]."""
    return ExperimentConfig(
        name="distributed_train",
        train=TrainConfig(batch_size=32, num_steps=10_000,
                          mesh=MeshConfig(num_data=-1)),
    )


PRESETS = {
    "audio_only": audio_only,
    "visual_only": visual_only,
    "fusion": fusion,
    "longseq_eval": longseq_eval,
    "distributed_train": distributed_train,
}
