"""Command line of the port: train / eval / predict / serve / doctor / export /
inspect / profile.

Counterpart of ``m3f/pytorch_tpu/main.py``, with the same subcommands, flags
and output; ``tests/test_torch_cli.py`` holds each against the JAX CLI. A
named preset (``--preset``, with the stackable ``+lane`` / ``+s2d``
variants) and dotted ``key=value`` overrides build the config. ``--device``
(default ``cuda``) is where train / eval / predict / serve run; without a GPU
it raises unless ``--device cpu`` is given.

    python -m m3f_torch.main train --preset fusion data.root=/data/abaw \\
        data.synthetic=false train.batch_size=8
    python -m m3f_torch.main eval --preset longseq_eval --split val \\
        --checkpoint ckpt/ckpt_00001000.npz data.root=/data/abaw
    python -m m3f_torch.main predict --split test --out submission/ \\
        --checkpoint a.npz,b.npz data.root=/data/abaw
    python -m m3f_torch.main serve --checkpoint best.npz --port 8321
    python -m m3f_torch.main doctor data.root=/data/abaw
    python -m m3f_torch.main export --format torch --checkpoint c.npz --out c.pt
    python -m m3f_torch.main inspect ckpt/ckpt_00001000.npz
    python -m m3f_torch.main profile ckpt/trace

``train`` runs data-parallel over several processes, one a card, when the
launch says so (``parallel/mesh.py``): ``--coordinator host:port,n,id`` (or
``M3F_COORDINATOR``) on every process, or torchrun's environment. Each
row of the data axis feeds its own ``batch_size / n`` rows
(``process_sharded_stream``), rank 0 writes the checkpoints, and the
checkpoint directory must be shared. ``train.mesh.num_model=k`` makes rows
of k processes that hold the same rows and run the BiGRU and the fusion
head tensor-parallel (each holding its blocks of their weights).

    torchrun --nproc_per_node 4 -m m3f_torch.main train \
        --preset distributed_train data.root=/data/abaw
    torchrun --nproc_per_node 4 -m m3f_torch.main train \
        --preset distributed_train train.mesh.num_model=2 data.root=/data/abaw

Not carried over, and refused with a ``NotImplementedError`` that names
ROADMAP: the JAX package's XLA compilation cache (``M3F_JAX_CACHE``) and
``export --format stablehlo``; the JAX launchers' variables
(``JAX_COORDINATOR_ADDRESS``, ``MEGASCALE_COORDINATOR_ADDRESS``, a
multi-host ``TPU_WORKER_HOSTNAMES``) are refused by name.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from typing import Dict, List

import numpy as np

from m3f_torch.config import ExperimentConfig, PRESETS, apply_overrides
from m3f_torch.data.synthetic import SyntheticAVDataset
from m3f_torch.data.windowing import (WindowSequencer, needs_dynamic_hop,
                                      process_grid, process_sharded_stream)
from m3f_torch.parallel.mesh import maybe_initialize_distributed
from m3f_torch.train.checkpoint import Checkpointer
from m3f_torch.train.loop import Trainer
from m3f_torch.utils.logging import MetricWriter, console_log


# base presets plus the stackable variants of each
_PRESET_VARIANTS = {
    "lane": {"model.visual.mid_mode": "lane"},
    "s2d": {"model.visual.stem_s2d": True},
}
_VARIANT_COMBOS = [
    "+".join(c)
    for r in range(1, len(_PRESET_VARIANTS) + 1)
    for c in itertools.permutations(sorted(_PRESET_VARIANTS), r)
]
_PRESET_CHOICES = sorted(PRESETS) + [p + "+" + v
                                     for p in sorted(PRESETS)
                                     for v in _VARIANT_COMBOS]


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def build_config(preset: str, overrides: List[str]) -> ExperimentConfig:
    # "<preset>+lane+s2d" = stacked variants: "lane" = lane-rounded midplanes
    # (visual.mid_mode="lane"), "s2d" = the space-to-depth stem
    base, *variants = preset.split("+")
    cfg = PRESETS[base]()
    for variant in variants:
        if variant not in _PRESET_VARIANTS:
            raise SystemExit(f"unknown preset variant '+{variant}' "
                             f"(know: {', '.join('+' + v for v in _PRESET_VARIANTS)})")
        cfg = apply_overrides(cfg, _PRESET_VARIANTS[variant])
    kv = {}
    for o in overrides:
        if "=" not in o:
            raise SystemExit(f"override '{o}' is not key=value")
        k, _, v = o.partition("=")
        kv[k] = _parse_value(v)
    return apply_overrides(cfg, kv)


def make_dataset(cfg: ExperimentConfig, split: str):
    if cfg.data.root and not cfg.data.synthetic:
        from m3f_torch.data.affwild2 import AffWild2Dataset
        return AffWild2Dataset(cfg.data, cfg.model.mel, split=split)
    return SyntheticAVDataset(cfg.data, cfg.model.mel)


def refuse_xla_cache(env=None) -> None:
    env = os.environ if env is None else env
    if env.get("M3F_JAX_CACHE"):
        raise NotImplementedError(
            "M3F_JAX_CACHE names the JAX package's XLA compilation cache, "
            "which is not carried over to the port (its kernels are cached "
            "under build/kernels; ROADMAP §1, not carried over): unset it")


def train_stream(cfg: ExperimentConfig, dataset, hop_aware: bool,
                 axis=None):
    """The train input of ``cmd_train``: ``factory(skip_batches)`` → this
    process's batches of ``dataset`` (``batch_size / n`` rows a row of the
    data axis ``axis``, the trainer's mesh: each row a disjoint share of
    the data, the same for the ranks of a row; default: every process of
    the ``torch.distributed`` group a row) through a ``Prefetcher``.
    ``fit`` calls it after the checkpoint restore with the restored step,
    so a resumed run's stream fast-forwards to the exact position an
    uninterrupted run would be at."""
    from m3f_torch.data.native_loader import Prefetcher
    index, world = process_grid() if axis is None else (axis.rank, axis.size)
    seq = WindowSequencer(cfg.window, cfg.model.mel, fps=cfg.data.fps,
                          mel_frames=cfg.model.audio.mel_frames_per_window,
                          per_frame=cfg.model.per_frame,
                          hop_aware=hop_aware)

    def factory(skip_batches: int = 0):
        return Prefetcher(
            process_sharded_stream(dataset, seq, cfg.train.batch_size // world,
                                   seed=cfg.train.seed,
                                   shuffle_buffer=cfg.data.shuffle_buffer,
                                   skip_batches=skip_batches,
                                   cache_videos=cfg.data.cache_videos,
                                   process_index=index, process_count=world),
            depth=cfg.data.prefetch)
    return factory


def cmd_train(cfg: ExperimentConfig, args) -> int:
    if getattr(args, "init_from", ""):
        cfg = apply_overrides(cfg, {"model.init_from": args.init_from})
    # train.debug_nans is the config's: Trainer.fit honours it
    import torch.distributed as dist
    env = dict(os.environ)
    if getattr(args, "coordinator", ""):
        env["M3F_COORDINATOR"] = args.coordinator
    joined = not dist.is_initialized()
    plan = maybe_initialize_distributed(env, device=args.device)
    try:
        return _train(cfg, args, plan)
    finally:
        # leave a group this call did not make as it was
        if plan.initialize and joined:
            dist.destroy_process_group()


def _train(cfg: ExperimentConfig, args, plan) -> int:
    rank, world = process_grid()
    device = args.device
    if plan.initialize:
        print(f"distributed: {plan.reason} -> process {rank}/{world}")
        if device == "cuda":
            import torch
            device = f"cuda:{torch.cuda.current_device()}"
    trainer = Trainer(cfg, device=device)
    ds = make_dataset(cfg, "train")
    # per-video mel hop: enabled when the corpus has off-rate videos, so each
    # window's 16 mel frames track its video's 16 frames at the true rate;
    # the decision is the JAX CLI's, so both feed the same windows
    off_rate = cfg.model.use_audio and needs_dynamic_hop(
        ds, cfg.model.mel, cfg.data.fps)
    # the JAX package's pallas mel frontend frames at a compile-time stride
    # and keeps the fixed nominal hop; the port's kernel could take the
    # per-entry hop, but keeps the reference's windows (ROADMAP §3)
    hop_aware = off_rate and cfg.model.mel_backend != "pallas"
    if hop_aware:
        print("per-video mel hop: dataset has off-rate videos — hop-aware "
              "windowing enabled (one shared dynamic-hop train program)")
    elif off_rate:
        print("WARNING: dataset has off-rate videos but "
              "model.mel_backend='pallas' frames at a compile-time stride — "
              "keeping the fixed nominal mel hop (audio time base warps by "
              "up to ~1/5 window at 25 fps; use model.mel_backend=xla for "
              "the per-video hop)")
    stream = train_stream(cfg, ds, hop_aware, trainer.mesh)
    # eval during training is the default (best-checkpoint tracking and
    # early stopping depend on it); --no-eval opts out
    val = None if args.no_eval else make_dataset(cfg, "val")
    ckpt = Checkpointer(cfg.train.checkpoint_dir, cfg.train.keep_checkpoints, cfg)
    if getattr(args, "resume_from", ""):
        ckpt.seed_from(args.resume_from)
    writer = MetricWriter(cfg.train.checkpoint_dir, "train")
    # trainer._last_state is refreshed after every step
    ckpt.install_preemption_handler(lambda: trainer._last_state)
    state, _ = trainer.fit(stream, val_dataset=val, log=console_log,
                           checkpointer=ckpt, metric_writer=writer)
    ckpt.save(state)
    writer.close()
    return 0


def _load_states(trainer, checkpoint_arg: str):
    """--checkpoint "a.npz" or "a.npz,b.npz,..." → list of committed states.

    The comma form is the prediction-level ensemble: eval / predict average
    the k models' per-frame tracks (``Trainer.evaluate_ensemble`` /
    ``predict_ensemble``). Accepts TrainState checkpoints and
    ``import_torch_checkpoint`` {params, state} files. One ``init_state``
    is the load template of every member (read for names and shapes only);
    ``commit_state(eval_only=True)`` gives each member tensors of its own
    on the device, without optimizer state.
    """
    from m3f_torch.train.checkpoint import load_model_checkpoint
    paths = [p.strip() for p in checkpoint_arg.split(",") if p.strip()]
    if not paths:
        raise SystemExit(
            f"--checkpoint {checkpoint_arg!r} contains no checkpoint paths")
    template = trainer.init_state()
    return [trainer.commit_state(load_model_checkpoint(template, p),
                                 eval_only=True) for p in paths]


def cmd_eval(cfg: ExperimentConfig, args) -> int:
    trainer = Trainer(cfg, device=args.device)
    # --per-video: one JSON row per video (which videos drag the mean down)
    row = (lambda vid, r: print(json.dumps(
        {"video": vid, "ccc_v": r["ccc_v"], "ccc_a": r["ccc_a"]}))
    ) if args.per_video else None
    ds = make_dataset(cfg, args.split)
    states = _load_states(trainer, args.checkpoint) if args.checkpoint \
        else [trainer.init_state()]
    if len(states) > 1:
        res = trainer.evaluate_ensemble(states, ds,
                                        max_videos=args.max_videos,
                                        per_video_fn=row)
    else:
        res = trainer.evaluate(states[0], ds, max_videos=args.max_videos,
                               per_video_fn=row)
    print(json.dumps(res))
    return 0


def cmd_export(args) -> int:
    """Export weights: ``--format torch`` writes a checkpoint npz as a
    reference-schema torch state_dict .pt (``scripts/
    export_torch_checkpoint``); ``--format stablehlo`` is not carried over."""
    if args.format == "stablehlo":
        raise NotImplementedError(
            "export --format stablehlo is the JAX package's XLA serving "
            "artifact and is not carried over to the port (ROADMAP §1, not "
            "carried over); use --format torch")
    if not args.checkpoint:
        raise SystemExit("--format torch requires --checkpoint")
    from m3f_torch.scripts import export_torch_checkpoint
    return export_torch_checkpoint.main([args.checkpoint, args.out])


def cmd_predict(cfg: ExperimentConfig, args) -> int:
    """Full-video predictions → ABAW submission txts."""
    from m3f_torch.infer.submission import write_submission
    if cfg.window.eval_smooth > 1 and args.smooth > 1:
        # both the eval smoother and the submission smoother would run —
        # almost certainly not what the user wants
        raise SystemExit("window.eval_smooth and --smooth are both set; "
                         "predictions would be smoothed twice — pick one")
    trainer = Trainer(cfg, device=args.device)
    states = _load_states(trainer, args.checkpoint) if args.checkpoint \
        else [trainer.init_state()]
    ds = make_dataset(cfg, args.split)
    preds: Dict[str, np.ndarray] = {}
    valids: Dict[str, np.ndarray] = {}
    ids = ds.video_ids()
    if args.max_videos:
        ids = ids[: args.max_videos]

    # pipelined: the next video's decode and upload overlap this one's work
    def load(vid):
        video = ds.load_video(vid)
        valids[vid] = video["valid"]
        return vid, video

    if len(states) > 1:
        # checkpoint ensemble: mean per-frame track over the k models
        for vid in ids:
            v, video = load(vid)
            preds[v] = trainer.predict_ensemble(states, video)
    else:
        for vid, r in trainer.evaluate_stream(states[0],
                                              (load(v) for v in ids)):
            preds[vid] = r["pred"]
    write_submission(args.out, preds, valids, smooth_window=args.smooth)
    print(f"wrote {len(preds)} submission files to {args.out}")
    return 0


def cmd_profile(args) -> int:
    """Summarize a ``torch.profiler`` trace directory (device time by op)."""
    from m3f_torch.utils.profiling import summarize_trace
    for row in summarize_trace(args.dir, top=args.top, group=not args.full):
        extra = (f" x{row['count']:<3d} {row['detail']}"
                 if "detail" in row else "")
        print(f"{row['ms']:10.2f} ms {row['percent']:5.1f}%  {row['op']}{extra}")
    return 0


def cmd_inspect(args) -> int:
    """Checkpoint archaeology without a model or a device: meta (step,
    config hash, best metric), layout, and a per-group size/dtype breakdown
    from the npz headers. Pure numpy."""
    ok = True
    for path in args.checkpoint:
        with np.load(path) as z:
            meta = {}
            if "__meta__" in z.files:
                meta = json.loads(bytes(z["__meta__"]).decode())
            keys = [k for k in z.files if k != "__meta__"]
            groups = {}
            total_bytes = 0
            dtypes = {}
            for k in keys:
                a = z[k]
                # trainer checkpoints hold TrainState fields with a leading
                # "." (".params/...", ".opt_state/..."); imported model-only
                # files plain paths ("params/..."): normalize per component
                parts = [p.lstrip(".") for p in k.split("/")]
                # params/<branch>/... groups by branch; everything else by root
                g = "/".join(parts[:2]) if parts[0] in ("params", "ema")  \
                    and len(parts) > 1 else parts[0]
                st = groups.setdefault(g, [0, 0])
                st[0] += 1
                st[1] += a.nbytes
                total_bytes += a.nbytes
                dtypes[str(a.dtype)] = dtypes.get(str(a.dtype), 0) + a.nbytes
            roots = {k.split("/")[0].lstrip(".") for k in keys}
            layout = ("TrainState (resumable: params+opt+step"
                      + ("+ema" if "ema" in roots else "") + ")"
                      if {"params", "opt_state"} <= roots
                      else "model-only (eval/serve/init-from)"
                      if "params" in roots or "state" in roots
                      else "unknown")
        # trainer checkpoints embed the full nested config under
        # meta["config"]: summarize it to its section count so the
        # description stays one line (the hash is the identity anyway)
        meta_view = {k: (f"<{len(v)} sections>" if k == "config"
                         and isinstance(v, dict) else v)
                     for k, v in meta.items()}
        row = {"path": path, "layout": layout, "leaves": len(keys),
               "mbytes": round(total_bytes / 2**20, 2), **meta_view}
        if args.json:
            print(json.dumps({**row, "groups": {g: {"leaves": c, "mbytes":
                  round(b / 2**20, 2)} for g, (c, b) in sorted(groups.items())},
                  "dtype_mbytes": {d: round(b / 2**20, 2)
                                   for d, b in sorted(dtypes.items())}}))
        else:
            meta_s = " ".join(f"{k}={v}" for k, v in meta_view.items())
            print(f"{path}: {layout}")
            print(f"  {len(keys)} leaves, {total_bytes / 2**20:.2f} MiB"
                  + (f"  [{meta_s}]" if meta_s else "  [no meta]"))
            for g, (c, b) in sorted(groups.items(),
                                    key=lambda kv: -kv[1][1]):
                print(f"  {b / 2**20:10.2f} MiB  {c:4d} leaves  {g}")
            print("  dtypes: " + ", ".join(
                f"{d}={b / 2**20:.2f}MiB" for d, b in sorted(dtypes.items())))
        ok = ok and layout != "unknown"
    return 0 if ok else 1


def _add_device(sp) -> None:
    sp.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default; raises "
                         "without a GPU) or cpu (the kernels' plain versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="m3f-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("inspect",
                        help="describe checkpoint npz files (meta, layout, "
                             "size breakdown) without loading a model")
    sp.add_argument("checkpoint", nargs="+")
    sp.add_argument("--json", action="store_true",
                    help="one JSON line per file")
    sp = sub.add_parser("profile", help="summarize a profiler trace dir")
    sp.add_argument("dir")
    sp.add_argument("--top", type=int, default=15)
    sp.add_argument("--full", action="store_true",
                    help="one row per kernel with its launch detail "
                         "(instead of grouping by op kind)")
    for name in ("train", "eval", "predict"):
        sp = sub.add_parser(name)
        sp.add_argument("--preset", default="fusion", choices=_PRESET_CHOICES)
        sp.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
        _add_device(sp)
        if name == "train":
            sp.add_argument("--coordinator", default="",
                            help="multi-process rendezvous "
                                 "host:port[,num_processes,process_id] "
                                 "(sets M3F_COORDINATOR)")
            sp.add_argument("--no-eval", action="store_true",
                            help="skip periodic eval (disables best-ckpt/early stop)")
            sp.add_argument("--init-from", default="",
                            help="pretrained .npz from import_torch_checkpoint "
                                 "(backbone-only or full model; = model.init_from)")
            sp.add_argument("--resume-from", default="",
                            help="full TrainState checkpoint to seed a FRESH "
                                 "checkpoint_dir from; ignored when the dir "
                                 "already has checkpoints")
        else:
            sp.add_argument("--checkpoint", default="",
                            help="TrainState or imported npz; a comma list "
                                 "'a.npz,b.npz' evaluates/predicts the "
                                 "prediction-level ensemble (mean per-frame "
                                 "track of the k models)")
            sp.add_argument("--max-videos", type=int, default=0)
            # predict on "test" = ABAW submission videos (crops, no labels);
            # eval needs labels so test is predict-only
            sp.add_argument("--split", default="val",
                            choices=(("train", "val") if name == "eval"
                                     else ("train", "val", "test")))
        if name == "eval":
            sp.add_argument("--per-video", action="store_true",
                            help="print one JSON row of CCCs per video")
        if name == "predict":
            sp.add_argument("--out", default="submission")
            sp.add_argument("--smooth", type=int, default=1,
                            help="moving-average smoothing window (frames)")
    sp = sub.add_parser("serve", help="HTTP prediction server over one model")
    sp.add_argument("--preset", default="longseq_eval", choices=_PRESET_CHOICES)
    sp.add_argument("--checkpoint", default="")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8321)
    sp.add_argument("--warmup-frames", type=int, default=1024,
                    help="run every input shape up to this many frames "
                         "before serving (0 = the first request pays)")
    sp.add_argument("--warmup-fps", default="",
                    help="comma list of expected client frame rates to "
                         "warm (?fps=R whole-video requests), e.g. 25,24")
    sp.add_argument("--max-streams", type=int, default=64,
                    help="concurrent live-stream session cap (429 beyond)")
    sp.add_argument("--stream-ttl", type=float, default=300.0,
                    help="evict live streams idle this many seconds "
                         "(410 on next touch; 0 = never evict)")
    sp.add_argument("--push-timeout", type=float, default=30.0,
                    help="max seconds a push may wait behind the "
                         "micro-batcher before answering 503")
    sp.add_argument("--allow-reload", action="store_true",
                    help="enable POST /reload (hot weight swap from a "
                         "server-side checkpoint path; operator endpoint, "
                         "off by default)")
    sp.add_argument("--max-body-mb", type=int, default=256,
                    help="per-request body cap in MiB (413 before any byte "
                         "is buffered beyond it)")
    _add_device(sp)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("doctor",
                        help="dataset pre-flight: scan the ABAW tree for "
                             "wav-rate/fps/crop/annotation problems "
                             "(header reads only, no decode)")
    sp.add_argument("--preset", default="fusion", choices=_PRESET_CHOICES)
    sp.add_argument("--splits", default="train,val,test")
    sp.add_argument("--json", action="store_true",
                    help="one JSON row per video instead of console lines")
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("export", help="export weights")
    sp.add_argument("--preset", default="fusion", choices=_PRESET_CHOICES)
    sp.add_argument("--checkpoint", default="", help="TrainState or imported npz")
    sp.add_argument("--format", choices=("torch", "stablehlo"), required=True,
                    help="torch: reference-schema state_dict .pt; "
                         "stablehlo: not carried over (raises)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--batch", type=int, default=8, help="stablehlo batch dim")
    sp.add_argument("--platforms", default="cpu,tpu")
    sp.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    if args.cmd == "inspect":
        return cmd_inspect(args)     # pure numpy — never touches a device
    if args.cmd == "profile":
        return cmd_profile(args)
    if args.cmd == "export":
        return cmd_export(args)
    refuse_xla_cache()
    cfg = build_config(args.preset, args.overrides)
    console_log(f"config {cfg.name} hash={cfg.config_hash()}")
    if args.cmd == "doctor":
        from m3f_torch.data.doctor import run_doctor
        return run_doctor(cfg, splits=tuple(
            s for s in args.splits.split(",") if s), as_json=args.json)
    if args.cmd == "serve":
        from m3f_torch.infer import Predictor
        from m3f_torch.infer.server import run_server
        rates = tuple(float(r) for r in args.warmup_fps.split(",") if r)
        return run_server(Predictor(cfg=cfg, checkpoint=args.checkpoint,
                                    device=args.device),
                          host=args.host, port=args.port,
                          warmup_frames=args.warmup_frames,
                          max_streams=args.max_streams,
                          stream_ttl_s=args.stream_ttl,
                          push_timeout_s=args.push_timeout,
                          warmup_rates=rates,
                          allow_reload=args.allow_reload,
                          max_body=args.max_body_mb << 20)
    return {"train": cmd_train, "eval": cmd_eval, "predict": cmd_predict}[args.cmd](cfg, args)


if __name__ == "__main__":
    sys.exit(main())
