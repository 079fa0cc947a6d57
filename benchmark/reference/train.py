"""DaliID's training step, written out plainly, for the first steps of a run.

One step (``Person-ReID/train_encodersKIT.py:45-249``): augment the uint8
batch (:mod:`.augment`), forward in train mode, L2-normalize the embedding,
center loss + ``lambda_proxy`` x proxy loss against the epoch's mined
centers and proxies; for TransReID-JPM also each branch's cross entropy and
softmax triplet, mixed 0.5 global + 0.5 mean of the 4 local branches, on
the embedding ``[global, locals / 4]``. Then the backward, Adam with L2
decay added to the gradient at the epoch's learning rate, and the momentum
model's EMA ``beta m + (1 - beta) o`` over parameters and BN statistics.
The model is the configuration's reference module (``spec``, ``forward``).
"""

from __future__ import annotations

import torch

from benchmark.reference import augment, losses
from benchmark.reference.precision import Precision


def lr_at(base_lr: float, epoch: int) -> float:
    """100 epochs at lr, 100 at lr / 10, then lr / 100 (``mainKIT.py:129-132``)."""
    return base_lr if epoch <= 100 else base_lr / 10 if epoch <= 200 else base_lr / 100


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class ReferenceTrainer:
    """The online and momentum models as dicts of float32 tensors on one
    device, Adam over the online model's parameters, and the generators of
    the augmentation (CPU) and of stochastic depth (the device)."""

    def __init__(self, model, config: dict, weights: dict, train: dict, seed: int,
                 prec: Precision | None = None):
        self.model, self.config = model, config
        self.cfg = train
        self.prec = prec or Precision()
        self.P = {k: v.detach().clone().requires_grad_(not is_statistic(k))
                  for k, v in weights.items()}
        self.M = {k: v.detach().clone() for k, v in weights.items()}
        self.params = [k for k in self.P if not is_statistic(k)]
        self.opt = torch.optim.Adam([self.P[k] for k in self.params], lr=train["base_lr"],
                                    weight_decay=train["weight_decay"])
        dev = next(iter(weights.values())).device
        self.aug_gen = torch.Generator().manual_seed(seed)
        self.drop_gen = torch.Generator(device=dev).manual_seed(seed)

    def augment(self, images_u8: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images_u8.shape
        return augment.augment(images_u8, augment.draw(b, h, w, self.aug_gen))

    def loss(self, x, labels, levels, mask, pset, epoch):
        cfg = self.cfg
        out = self.model.forward(self.config, self.P, x, True, self.prec, self.drop_gen)
        total = 0.0
        if isinstance(out, tuple):
            scores, feats = out
            args = (labels, levels, mask)

            def mix(t):
                return 0.5 * t[0] + 0.5 * torch.stack(t[1:]).mean()

            ce = [losses.cross_entropy(s, *args, epoch, cfg["num_epochs"]) for s in scores]
            tri = [losses.softmax_triplet(f / (f.norm(dim=1, keepdim=True) + 1e-9), *args,
                                          epoch, cfg["num_epochs"], cfg["tau"]) for f in feats]
            total = mix(ce) + mix(tri)
            out = torch.cat([feats[0]] + [f / 4.0 for f in feats[1:]], dim=1)
        f = out / (out.norm(dim=1, keepdim=True) + 1e-9)
        centers, proxies, plabels = pset
        c = losses.center_loss(f, labels, levels, mask, centers, epoch, cfg["num_epochs"],
                               cfg["tau"])
        p = losses.proxy_loss(f, labels, levels, mask, proxies, plabels, epoch,
                              cfg["num_epochs"], cfg["tau"])
        return total + c + cfg["lambda_proxy"] * p

    def step(self, images_u8, labels, levels, mask, pset, epoch) -> tuple:
        """One optimizer step → (loss, the augmented batch)."""
        for g in self.opt.param_groups:
            g["lr"] = lr_at(self.cfg["base_lr"], epoch)
        x = self.augment(images_u8)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(x, labels, levels, mask, pset, epoch)
        loss.backward()
        self.opt.step()
        beta = self.cfg["beta"]
        with torch.no_grad():
            for k, m in self.M.items():
                m.mul_(beta).add_(self.P[k].detach(), alpha=1.0 - beta)
        return float(loss.detach()), x

    def first_grads(self) -> dict:
        """Each parameter's gradient as Adam took it on the first step, from
        Adam's first moment: ``exp_avg / (1 - beta1)``."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        return {k: self.opt.state[self.P[k]]["exp_avg"] / (1.0 - beta1) for k in self.params}
