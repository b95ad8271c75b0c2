"""One rank of a four-process ``torch.distributed`` job of the port on the
CPU (gloo), for tests/test_torch_tensor_parallel.py and
tests/test_torch_seqpar.py.

Not a test file: each test module launches it four times,

    python tests/torch_tp_worker.py RANK WORLD PORT OUT_DIR CASE[,CASE...]

and each rank joins the group through the port's own launcher, runs the
named cases of ``CASES`` in order ("cli", the command line in the same
group, goes last) and writes what it got to ``OUT_DIR/<case>.rank<r>.npz``. The inputs the cases share with the test
(the JAX package's initial weights and checkpoint, the sequence-parallel
inputs) are files the test wrote into ``OUT_DIR`` before the launch. The
configs and the step loop are shared with the tests. Imports no JAX.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the CLI's MetricWriter opens a TensorBoard writer; TensorBoard's optional
# TensorFlow import takes seconds and is not under test here
sys.modules.setdefault("tensorflow", None)

import numpy as np
import torch
import torch.distributed as dist

import m3f_torch.config as tc
from m3f_torch.data.windowing import samples_per_window
from m3f_torch.models.gru import BiGRU, GRUCell
from m3f_torch.parallel.mesh import create_mesh, gather_rows, local_rows
from m3f_torch.parallel.seqpar import bigru_seq_parallel, gru_seq_parallel
from m3f_torch.train.checkpoint import Checkpointer, from_jax_params
from m3f_torch.train.loop import Trainer

STEPS = 3
SEQ_B, SEQ_D, SEQ_H = 2, 6, 5          # tests/test_seqpar.py's GRU
BI_D, BI_H = 6, 4                      # ... its BiGRU
BF_D, BF_H = 12, 8                     # ... its bf16 BiGRU


def tiny_cfg(mod, n_data: int, n_model: int, ema: float = 0.5):
    """tests/test_tensor_parallel.py's config (3H = 24 and the head's 16
    rows divide over 2 and 4 model ranks), with its EMA test's decay."""
    return mod.ExperimentConfig(
        name="tiny_tp",
        model=mod.ModelConfig(
            use_audio=True, use_video=False,
            audio=mod.AudioNetConfig(channels=(4, 8), feature_dim=8),
            gru=mod.GRUConfig(hidden_size=8), compute_dtype="float32"),
        window=mod.WindowConfig(windows_per_clip=2),
        train=mod.TrainConfig(batch_size=8, ema_decay=ema,
                              mesh=mod.MeshConfig(num_data=n_data,
                                                  num_model=n_model)))


def make_batch(cfg, B: int = 8, seed: int = 0) -> dict:
    """tests/test_tensor_parallel.py's ``make_batch``."""
    rng = np.random.RandomState(seed)
    W = cfg.window.windows_per_clip
    L = cfg.model.frames_per_window
    spw = samples_per_window(cfg.model.mel,
                             cfg.model.audio.mel_frames_per_window)
    return {"wav": rng.randn(B, W, spw).astype(np.float32),
            "labels": rng.uniform(-1, 1, (B, W, L, 2)).astype(np.float32),
            "mask": np.ones((B, W, L), dtype=bool)}


def jax_init(out: str):
    """The JAX package's initial (params, bn_state) numpy trees the test
    left in ``out``."""
    with open(os.path.join(out, "jax_init.pkl"), "rb") as f:
        return pickle.load(f)


def trainer_from_jax(cfg, out: str) -> Trainer:
    """A trainer whose model holds this rank's blocks of the JAX init."""
    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(from_jax_params(*jax_init(out), tp=tr.tp))
    return tr


def dump_state(state, prefix: str = "") -> dict:
    """Every tensor leaf of a state as this rank holds it (``blk/``) and
    whole (``full/``, the sharded ones gathered over the model axis)."""
    tp = state.tp
    groups = {"p": state.params, "b": state.bn_state, "e": state.ema or {}}
    inner = state.opt_state.get("inner", state.opt_state)
    groups.update({k: inner[k] for k in ("mu", "nu", "trace") if k in inner})
    res = {}
    for g, tensors in groups.items():
        for n, t in tensors.items():
            t = t.detach()
            res[f"{prefix}blk/{g}/{n}"] = t.numpy().copy()
            whole = t if tp is None else tp.full(n, t)
            res[f"{prefix}full/{g}/{n}"] = whole.numpy().copy()
    return res


def run_train(cfg, out: str, steps: int = STEPS) -> dict:
    """``steps`` steps of ``cfg`` from the JAX init on the seeded batches
    of tests/test_tensor_parallel.py, this rank's rows of each."""
    tr = trainer_from_jax(cfg, out)
    state = tr.init_state(keep_weights=True)
    res = {k: [] for k in ("loss", "grad_norm")}
    for i in range(steps):
        m = tr.train_step(state, local_rows(make_batch(cfg, seed=i), tr.mesh))
        for k in res:
            res[k].append(float(m[k]))
    res = {k: np.asarray(v, np.float64) for k, v in res.items()}
    res.update(dump_state(state))
    return res, tr, state


def case_mesh(out: str) -> dict:
    """The meshes of four ranks: 2 x 2 and 1 x 4 (rows, columns, the rank
    layout), one laid out over interleaved nodes (a column whose order is
    not its group's: ``gather_rows`` must keep the axis order), and the
    refusals of a world of the wrong shape."""
    res = {}
    for nd, nm in ((2, 2), (1, 4), (-1, 2), (4, 1)):
        m = create_mesh(nd, nm)
        res[f"{nd}x{nm}"] = np.asarray(
            [m.size, m.rank, m.model.size, m.model.rank]
            + list(m.ranks) + list(m.model.ranks))
    m = create_mesh(2, 2, node_ids=[1, 0, 1, 0])
    res["nodes_layout"] = np.asarray(m.layout)
    res["nodes_axes"] = np.asarray([m.rank, m.model.rank] + list(m.ranks)
                                   + list(m.model.ranks))
    me = torch.tensor([[float(dist.get_rank())]])
    res["nodes_gather_rows"] = gather_rows(me, m).numpy().ravel()
    errors = []
    for nd, nm in ((3, 2), (1, 2), (-1, 3), (2, 4)):
        try:
            create_mesh(nd, nm)
            errors.append(f"{nd}x{nm} built")
        except ValueError as e:
            errors.append(str(e))
    res["refusals"] = np.asarray(errors)
    return res


def case_train(out: str) -> dict:
    """3 steps on a 2 x 2 mesh, then a checkpoint of the state
    (``ck22/``)."""
    cfg = tiny_cfg(tc, 2, 2)
    res, tr, state = run_train(cfg, out)
    Checkpointer(os.path.join(out, "ck22"), cfg=cfg).save(state)
    res["tp_dims"] = np.asarray(sorted(tr.tp.dims))
    return res


def case_eval(out: str) -> dict:
    """The eval forward on a 1 x 4 mesh (every rank one row)."""
    cfg = tiny_cfg(tc, 1, 4)
    tr = trainer_from_jax(cfg, out)
    b = make_batch(cfg, seed=7)
    return {"pred": tr.make_eval_forward()({"wav": b["wav"]}).numpy()}


def case_resume_jax(out: str) -> dict:
    """The JAX package's tensor-parallel checkpoint (``ck_jax/``) resumed
    on a 2 x 2 mesh, then written again (``ck22_from_jax/``)."""
    cfg = tiny_cfg(tc, 2, 2)
    tr = Trainer(cfg, device="cpu")
    state = Checkpointer(os.path.join(out, "ck_jax"), cfg=cfg).maybe_restore(
        tr.init_state(), tr)
    Checkpointer(os.path.join(out, "ck22_from_jax"), cfg=cfg).save(state)
    res = dump_state(state)
    res["step"] = np.asarray(state.step)
    return res


def case_cli(out: str, port: int) -> dict:
    """``m3f_torch.main train`` with ``train.mesh.num_model=2`` on the four
    ranks (a 2 x 2 mesh) through ``--coordinator`` (the group this process
    is in already)."""
    from m3f_torch import main as tmain
    rank, world = dist.get_rank(), dist.get_world_size()
    rc = tmain.main([
        "train", "--device", "cpu", "--preset", "audio_only", "--no-eval",
        "--coordinator", f"localhost:{port},{world},{rank}",
        "data.synthetic=true", "data.synthetic_num_videos=4",
        "data.synthetic_video_frames=64", "model.audio.channels=[4,8]",
        "model.audio.feature_dim=8", "model.gru.hidden_size=8",
        "train.batch_size=4", "train.num_steps=2", "train.log_every=1",
        "train.checkpoint_every=1", "data.prefetch=0",
        "train.mesh.num_model=2",
        f"train.checkpoint_dir={os.path.join(out, 'cli_ckpt')}"])
    return {"rc": np.asarray(rc)}


def seq_inputs(out: str) -> dict:
    with open(os.path.join(out, "seq_inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _cell(p: dict) -> GRUCell:
    cell = GRUCell(1, 1, torch.Generator())
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        setattr(cell, k, torch.nn.Parameter(torch.from_numpy(p[k].copy())))
    return cell


def _bigru(params: dict, d: int, h: int) -> BiGRU:
    m = BiGRU(d, h, torch.Generator(), num_layers=len(params["layers"]))
    for layer, p in zip(m.layers, params["layers"]):
        for dname in ("fwd", "bwd"):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(layer[dname], k).data.copy_(
                    torch.from_numpy(p[dname][k].copy()))
    return m


def _chunk(x: np.ndarray, axis) -> torch.Tensor:
    t = x.shape[1] // axis.size
    return torch.from_numpy(np.ascontiguousarray(
        x[:, axis.rank * t:(axis.rank + 1) * t]))


def case_seqpar(out: str) -> dict:
    """``gru_seq_parallel`` (both directions) and ``bigru_seq_parallel``
    (fp32 with its gradients, bf16) over the four ranks' data axis, each
    rank on its chunk of tests/test_seqpar.py's inputs → this rank's chunk
    of each output and of the input's gradient, and the weights'
    gradients."""
    inp = seq_inputs(out)
    axis = create_mesh(4, 1)
    res = {}
    cell = _cell(inp["gru"])
    for rev in (False, True):
        with torch.no_grad():
            res[f"gru_rev{int(rev)}"] = gru_seq_parallel(
                cell, _chunk(inp["gru_x"], axis), axis, reverse=rev).numpy()
    m = _bigru(inp["bigru"], BI_D, BI_H)
    x = _chunk(inp["bigru_x"], axis).requires_grad_()
    y = bigru_seq_parallel(m, x, axis)
    g = _chunk(inp["bigru_g"], axis)
    grads = torch.autograd.grad((y * g).sum(), [x] + list(m.parameters()))
    res["bigru"] = y.detach().numpy()
    res["bigru_dx"] = grads[0].numpy()
    for (n, _), gw in zip(m.named_parameters(), grads[1:]):
        res[f"bigru_d/{n}"] = gw.numpy()
    mb = _bigru(inp["bigru_bf16"], BF_D, BF_H)
    xb = _chunk(inp["bigru_bf16_x"], axis).bfloat16()
    with torch.no_grad():
        res["bigru_bf16"] = bigru_seq_parallel(mb, xb, axis).float().numpy()
    return res


CASES = {"mesh": case_mesh, "train": case_train, "eval": case_eval,
         "resume_jax": case_resume_jax, "seqpar": case_seqpar}


def main() -> int:
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    cases = sys.argv[5].split(",")
    torch.set_num_threads(1)
    from m3f_torch.parallel.mesh import maybe_initialize_distributed
    env = dict(os.environ, M3F_COORDINATOR=f"localhost:{port},{world},{rank}")
    plan = maybe_initialize_distributed(env, device="cpu")
    assert plan.initialize and plan.expect_processes == world, plan
    for case in cases:
        res = case_cli(out, port) if case == "cli" else CASES[case](out)
        np.savez(os.path.join(out, f"{case}.rank{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
