"""Training: the single-device pre-training loop.

Port of the unmeshed path of `mdi_llm_tpu/training.py`: init from scratch
or from given params, AdamW with weight decay masked to weight matrices,
a cosine learning rate with linear warmup, gradient accumulation with the
micro-batch gradients summed in float32, global-norm clipping, periodic
eval with `estimate_loss`, checkpoint-on-best with patience early stop,
and the TFLOP/s estimate of the log lines.

What differs from the JAX package:
- One device.  A mesh (dp/tp/sp/pp/ep) is refused: it waits for later
  slices (ROADMAP Queue 1, items 14-17).  MoE configs train in the dense
  formulation (`transformer.moe_forward`) with the load-balancing aux
  weighted by `moe_aux_weight`; `moe_capacity_factor` acts only on the
  token dispatch of an `ep` mesh (item 16), so anything but None is
  refused.
- The optimizer is written out (`AdamW`) with optax's arithmetic:
  `clip_by_global_norm` divides by the norm itself (torch's
  `clip_grad_norm_` adds 1e-6), the moments are float32, the update of
  step n uses `lr_schedule(n)` counted from 0, and bfloat16 params are
  updated in float32 and rounded once.
- With `use_flash`, attention runs through the autograd Functions of
  `ops/flash.py`: K2 forward with the LSE, K3 and K4 in the backward.
  `remat` recomputes each block in the backward (`torch.utils.checkpoint`),
  so K2 runs twice per layer and micro-batch and K3, K4 once.
- Checkpoints are the port's own files: `params.pt` and
  `model_config.yaml` (`utils/checkpoint.save_checkpoint`, read back by
  `load_checkpoint`), `opt_state.pt` (`torch.save`) and
  `train_state.json` with the JAX package's keys.
- Random init draws from a `torch.Generator` (`transformer.init_params`),
  so a scratch run starts from other numbers than the JAX package's; the
  parity tests hand both the same params.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.generation import resolve_device
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.utils import data_loader
from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NORMS = frozenset({"norm_1", "norm_2", "ln_f"})


@dataclass
class TrainingConfig:
    """Hyper-parameters (the JAX package's `TrainingConfig`)."""

    batch_size: int = 8
    block_size: Optional[int] = None  # None → cfg.block_size
    grad_acc_steps: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 1e-1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    decay_lr: bool = True
    warmup_iters: int = 2000
    lr_decay_iters: int = 600000
    min_lr: float = 6e-5
    max_iters: int = 600000
    eval_iters: int = 20
    ckpt_interval: int = 1000
    log_interval: int = 10
    patience: int = 5
    seed: int = 10137
    dtype: str = "bfloat16"  # params/compute dtype
    remat: bool = True
    # attention through K2 forward + the K3/K4 backward (ops/flash.py)
    # instead of the dense torch route; None → CUDA and block_size >= 2048
    use_flash: Optional[bool] = None
    # MoE: the load-balancing aux weight (0 for dense configs, as in the
    # JAX package); the capacity factor of the ep mesh's token dispatch
    # (item 16), refused unless None
    moe_aux_weight: float = 0.01
    moe_capacity_factor: Optional[float] = None


def get_lr(it: int, tc: TrainingConfig) -> float:
    """Cosine schedule with linear warmup."""
    if not tc.decay_lr:
        return tc.learning_rate
    if it < tc.warmup_iters:
        return tc.learning_rate * it / tc.warmup_iters
    if it > tc.lr_decay_iters:
        return tc.min_lr
    ratio = (it - tc.warmup_iters) / (tc.lr_decay_iters - tc.warmup_iters)
    coeff = 0.5 * (1.0 + np.cos(np.pi * ratio))
    return tc.min_lr + coeff * (tc.learning_rate - tc.min_lr)


def lr_schedule(tc: TrainingConfig):
    """Twin of `get_lr` in float32, as the JAX package's optax schedule
    computes it: a function of the update count (the constant learning rate
    when `decay_lr` is off)."""
    if not tc.decay_lr:
        return tc.learning_rate
    f = np.float32

    def sched(count):
        it = f(count)
        warm = f(tc.learning_rate) * it / f(max(tc.warmup_iters, 1))
        ratio = (it - f(tc.warmup_iters)) / f(max(tc.lr_decay_iters - tc.warmup_iters, 1))
        ratio = np.clip(ratio, f(0.0), f(1.0))
        coeff = f(0.5) * (f(1.0) + np.cos(f(np.pi) * ratio))
        cos_lr = f(tc.min_lr) + coeff * (f(tc.learning_rate) - f(tc.min_lr))
        return warm if it < tc.warmup_iters else cos_lr

    return sched


def cross_entropy_loss(
    cfg: Config, params, tokens, targets, remat=True, use_flash=False,
    flash_kernel: Optional[bool] = None, moe_aux_weight: float = 0.0,
) -> torch.Tensor:
    """Mean next-token CE in float32 over the padded vocabulary (the
    padding columns only enter the softmax normalizer).  `moe_aux_weight`
    > 0 adds that weight times the layer-mean load-balancing aux of an
    LLaMAMoE config."""
    B = tokens.shape[0]
    collect = moe_aux_weight > 0 and cfg.mlp_class_name == "LLaMAMoE"
    out = transformer.forward(
        cfg, params, tokens, torch.zeros(B, dtype=torch.long, device=tokens.device),
        remat=remat, use_flash=use_flash, flash_kernel=flash_kernel,
        collect_moe_aux=collect,
    )
    logits = out[0] if collect else out
    loss = F.cross_entropy(logits.float().flatten(0, 1), targets.flatten().long())
    if collect:
        loss = loss + moe_aux_weight * out[1] / cfg.n_layer
    return loss


def decay_mask(params) -> dict:
    """True where AdamW decays the leaf: `weight` leaves of two or more
    dims outside the norm subtrees.  The stacked layout makes per-layer
    norm weights and biases 2-D, so the rule goes by path, not by ndim
    alone (the JAX package's `leaf_mask`)."""

    def walk(tree, keys):
        return {
            k: walk(v, keys | {k}) if isinstance(v, dict)
            else k == "weight" and v.dim() >= 2 and not (keys | {k}) & NORMS
            for k, v in tree.items()
        }

    return walk(params, frozenset())


class AdamW:
    """`make_optimizer` of the JAX package: optax's
    `chain(clip_by_global_norm(grad_clip), adamw(lr_schedule, b1, b2,
    weight_decay, mask=decay_mask))`, step for step in float32.  The
    moments are float32, one per param leaf in `transformer.tree_leaves`
    order."""

    def __init__(self, tc: TrainingConfig, params):
        self.tc = tc
        self.lr = lr_schedule(tc)
        self.count = 0
        self.decay = transformer.tree_leaves(decay_mask(params))
        leaves = transformer.tree_leaves(params)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """Apply one update to the `params` leaves in place; `grads` are the
        float32 gradients (clipped in place)."""
        tc = self.tc
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if not bool(norm < tc.grad_clip):
            for g in grads:
                g.div_(norm).mul_(tc.grad_clip)
        lr = self.lr(self.count) if callable(self.lr) else tc.learning_rate
        self.count += 1
        f = np.float32
        bc1 = float(f(1.0) - f(tc.beta1) ** f(self.count))
        bc2 = float(f(1.0) - f(tc.beta2) ** f(self.count))
        for p, g, mu, nu, decay in zip(params, grads, self.mu, self.nu, self.decay):
            mu.mul_(tc.beta1).add_(g, alpha=1.0 - tc.beta1)
            nu.mul_(tc.beta2).addcmul_(g, g, value=1.0 - tc.beta2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(1e-8))
            if decay:
                u.add_(p * tc.weight_decay)  # the decay term in p's dtype, as optax
            u.mul_(-float(lr))
            p.copy_(u.add_(p))  # p + u in float32, rounded once to p's dtype

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for x, y in zip(mine, saved, strict=True):
                x.copy_(y)


def estimate_flops_per_token(cfg: Config, T: int) -> float:
    """PaLM-style estimate: 6N + 12·L·H·hs·T."""
    N = cfg.estimate_params()
    return 6.0 * N + 12.0 * cfg.n_layer * cfg.n_head * cfg.head_size * T


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"mdi_llm_tpu_torch trains on one device: {what} is not "
        f"ported yet (ROADMAP Queue 1, {item})"
    )


class Trainer:
    """Single-device trainer (the JAX `Trainer` without a mesh).

    `device` None means CUDA (and raises without a GPU); pass "cpu" to run
    on the CPU.  `flash_kernel=False` sends the flash route through the
    plain versions of K2-K4 on any device (the on-card parity check)."""

    def __init__(
        self,
        cfg: Config,
        tc: TrainingConfig,
        mesh: Optional[Any] = None,
        params: Optional[Any] = None,
        out_dir: Optional[Path] = None,
        device=None,
        flash_kernel: Optional[bool] = None,
    ):
        if mesh is not None:
            _refuse("a training mesh (dp/tp/sp/pp/ep)", "items 14-17")
        transformer.check_supported(cfg)
        if tc.moe_capacity_factor is not None:
            _refuse("moe_capacity_factor (the MoE token dispatch of an ep mesh)",
                    "item 16")
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.block_size = int(tc.block_size or cfg.block_size)
        self.out_dir = Path(out_dir) if out_dir else None
        self.iter_num = 0
        self.best_val_loss = float("inf")
        # the JAX gate with the TPU read as CUDA: the dense route wins below
        # 2048 there, and the threshold is kept until this card measures it
        self.use_flash = (
            self.device.type == "cuda" and self.block_size >= 2048
            if tc.use_flash is None
            else bool(tc.use_flash)
        )
        self.flash_kernel = flash_kernel
        # the aux term applies to MoE configs only, as in the JAX package
        self.moe_aux_weight = tc.moe_aux_weight if cfg.mlp_class_name == "LLaMAMoE" else 0.0
        dtype = DTYPES[tc.dtype]
        if params is None:
            params = transformer.init_params(cfg, tc.seed, dtype=dtype, device=self.device)
        else:
            # a private copy: the optimizer updates the params in place
            params = transformer.tree_map(
                lambda x: x.detach().to(device=self.device, dtype=dtype, copy=True),
                params,
            )
        transformer.tree_map(lambda x: x.requires_grad_(True), params)
        self.params = params
        self.optimizer = AdamW(tc, params)
        self._acc: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------------

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _loss(self, x, y, remat: bool) -> torch.Tensor:
        return cross_entropy_loss(
            self.cfg, self.params, x, y, remat=remat, use_flash=self.use_flash,
            flash_kernel=self.flash_kernel, moe_aux_weight=self.moe_aux_weight,
        )

    def train_step(self, xs: np.ndarray, ys: np.ndarray) -> float:
        """One optimizer step over (grad_acc_steps, batch, T) token arrays:
        the micro-batch gradients are summed in float32 and averaged."""
        xs, ys = self._tokens(xs), self._tokens(ys)
        leaves = transformer.tree_leaves(self.params)
        if self._acc is None:
            self._acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        else:
            for acc in self._acc:
                acc.zero_()
        losses = []
        for m in range(xs.shape[0]):
            loss = self._loss(xs[m], ys[m], self.tc.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(self._acc, grads):
                if g is not None:  # an unused leaf's gradient is zero
                    acc.add_(g)
            del grads
            losses.append(loss.detach())
        for acc in self._acc:
            acc.div_(xs.shape[0])
        self.optimizer.update(leaves, self._acc)
        self.iter_num += 1
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def eval_loss(self, x, y) -> float:
        """The loss of one batch, without gradients and without remat."""
        return float(self._loss(self._tokens(x), self._tokens(y), remat=False))

    @staticmethod
    def _sample_batch(data, batch_size, block_size, rng):
        """Accepts a token array (NumPy path) or any object exposing
        `.get_batch(batch, block)` (e.g. the native C++ loader)."""
        if hasattr(data, "get_batch"):
            return data.get_batch(batch_size, block_size)
        return data_loader.get_batch(data, batch_size, block_size, rng)

    def estimate_loss(self, data, rng) -> float:
        """Mean loss over eval_iters random batches."""
        losses = []
        for _ in range(self.tc.eval_iters):
            x, y = self._sample_batch(data, self.tc.batch_size, self.block_size, rng)
            losses.append(self.eval_loss(x, y))
        return float(np.mean(losses))

    def fit(
        self,
        train_data,
        val_data=None,
        max_iters: Optional[int] = None,
        log_cb=None,
    ) -> Dict[str, Any]:
        """Run the training loop: eval and checkpoint every ckpt_interval
        iterations (save on a new best, stop when patience runs out), a
        history entry every log_interval."""
        tc = self.tc
        max_iters = max_iters if max_iters is not None else tc.max_iters
        rng = np.random.default_rng(tc.seed + 1)
        flops_tok = estimate_flops_per_token(self.cfg, self.block_size)
        toks_per_iter = tc.grad_acc_steps * tc.batch_size * self.block_size
        patience_left = tc.patience
        history = []
        t0 = time.perf_counter()

        while self.iter_num < max_iters:
            if (
                self.iter_num % tc.ckpt_interval == 0
                and val_data is not None
                and self.iter_num > 0
            ):
                val_loss = self.estimate_loss(val_data, rng)
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    patience_left = tc.patience
                    if self.out_dir:
                        self.save(self.out_dir)
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        break
                history.append({"iter": self.iter_num, "val_loss": val_loss})

            xs = np.empty((tc.grad_acc_steps, tc.batch_size, self.block_size), np.int32)
            ys = np.empty_like(xs)
            for m in range(tc.grad_acc_steps):
                xs[m], ys[m] = self._sample_batch(
                    train_data, tc.batch_size, self.block_size, rng
                )
            loss = self.train_step(xs, ys)
            if self.iter_num % tc.log_interval == 0:
                dt = time.perf_counter() - t0
                tflops = flops_tok * toks_per_iter * self.iter_num / dt / 1e12
                history.append({"iter": self.iter_num, "loss": loss, "tflops": tflops})
                if log_cb:
                    log_cb(history[-1])
        return {
            "iter_num": self.iter_num,
            "best_val_loss": self.best_val_loss,
            "history": history,
        }

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, out_dir) -> Path:
        out_dir = save_checkpoint(self.params, self.cfg, out_dir)
        torch.save(self.optimizer.state_dict(), out_dir / "opt_state.pt")
        (out_dir / "train_state.json").write_text(
            json.dumps(
                {
                    "iter_num": self.iter_num,
                    "best_val_loss": self.best_val_loss,
                    "training_config": asdict(self.tc),
                }
            )
        )
        return out_dir

    @classmethod
    def resume(cls, out_dir, mesh: Optional[Any] = None, device=None) -> "Trainer":
        out_dir = Path(out_dir).resolve()
        state = json.loads((out_dir / "train_state.json").read_text())
        tc = TrainingConfig(**state["training_config"])
        cfg, params = load_checkpoint(out_dir, device=resolve_device(device))
        tr = cls(cfg, tc, mesh=mesh, params=params, out_dir=out_dir, device=device)
        del params
        tr.optimizer.load_state_dict(
            torch.load(out_dir / "opt_state.pt", map_location=tr.device)
        )
        tr.iter_num = state["iter_num"]
        tr.best_val_loss = state["best_val_loss"]
        return tr
