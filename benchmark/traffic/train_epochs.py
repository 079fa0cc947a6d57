"""Traffic kind ``train_epochs``: DaliID's training loop, epoch after epoch.

Set-up writes the cell's Market-shaped tree, builds the program's online
and momentum models from the seeded weights, its PK sampler and its
``Trainer``, and runs epoch 1 through ``Trainer.train_epoch`` (mining, then
the steps) until its fourth step is called: that warms every shape the
window uses (the mining batch and its padded tail, the step) and records
what the check compares. The window then runs whole epochs (``train_epoch``
2, 3, ...) until ``--seconds`` have passed; each starts with its proxy
mining, so mining is in the window as users pay for it.

``train_img_s`` is the images of the window's optimizer steps over the
window. After the window the reference follows the first three steps from
the same weights and batches (its own decode, augmentation, losses, Adam
and EMA), with the centers and proxies the program mined. Two minings are
checked: epoch 1's and the window's last. For each the reference re-embeds
a seeded sample of the training images from the weights that mining
started from, and mines the program's embeddings again with the miner's
generator as it stood; every epoch of the window has to have mined and
extracted. The window's mining follows the program's own trained weights:
the reference cannot follow the window's steps, so that mining is judged
from the state it started from, and the steps by the first three.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import gc
import os
import time

import numpy as np
import torch

from benchmark.harness import compare, datagen, models, tracing
from benchmark.reference import augment as ref_aug, mining as ref_mining, train as ref_train
from benchmark.reference.precision import Precision, set_strict_float32

CHECK_STEPS = 3


class _WarmupDone(Exception):
    pass


def make_tree(run) -> str:
    return datagen.make_tree(str(run.cache / "data"), run.workload["traffic"],
                             run.params["tree"], run.seed, 2 * (os.cpu_count() or 1))


class _Recorder:
    """Wraps the trainer's calls in epoch 1 to record what the check needs,
    and stops the epoch when its fourth step is called."""

    def __init__(self, trainer, weights: dict):
        self.t = trainer
        self.w = weights
        self.batches, self.losses = [], []
        self.aug = self.decoded = None
        self.feats = None
        self.pset = None
        self.grad_norms = self.update_norms = self.ema_norms = None
        self.steps = 0
        self._stage, self._augment = trainer._stage, trainer.augment
        self._step, self._mine = trainer.train_step, trainer.mine_proxies
        self._extract = trainer.extractor.extract
        trainer._stage, trainer.augment = self.stage, self.augment
        trainer.train_step, trainer.mine_proxies = self.step, self.mine
        trainer.extractor.extract = self.extract

    def restore(self):
        t = self.t
        t._stage, t.augment = self._stage, self._augment
        t.train_step, t.mine_proxies = self._step, self._mine
        t.extractor.extract = self._extract

    def stage(self, batch):
        out = self._stage(batch)
        if len(self.batches) < CHECK_STEPS:
            self.batches.append(batch)
        if self.decoded is None:
            self.decoded = out[0].clone()
        return out

    def augment(self, images_u8):
        out = self._augment(images_u8)
        if self.aug is None:
            self.aug = out.detach().float().clone()
        return out

    def extract(self, table, *a, **kw):
        out = self._extract(table, *a, **kw)
        if self.feats is None:
            self.feats = out
        return out

    def mine(self, *a, **kw):
        out = self._mine(*a, **kw)
        if self.pset is None:
            self.pset = out
        return out

    def step(self, *a, **kw):
        if self.steps == CHECK_STEPS:
            raise _WarmupDone()
        out = self._step(*a, **kw)
        self.steps += 1
        self.losses.append(float(out[0]))
        t = self.t
        names = [n for n, _ in t.online.named_parameters()]
        if self.steps == 1:
            beta1 = t.optimizer.param_groups[0]["betas"][0]
            # a parameter Adam holds no moment for was never given a gradient
            self.grad_norms = {
                n: float(t.optimizer.state[p]["exp_avg"].norm() / (1 - beta1))
                if "exp_avg" in t.optimizer.state.get(p, {}) else 0.0
                for n, p in zip(names, t._params)}
        if self.steps == CHECK_STEPS:
            self.update_norms = {n: float((p.detach() - self.w[n]).norm())
                                 for n, p in t.online.named_parameters()}
            self.ema_norms = {n: float((p.detach() - self.w[n]).norm())
                              for n, p in t.momentum.named_parameters()}
        return out


class _WindowMining:
    """Keeps, for the latest mining of the window, the weights and the
    miner's generator it started from, the embeddings it made and what it
    mined, and counts the minings. The weights are copied on the device."""

    def __init__(self, trainer):
        self.t, self.n = trainer, 0
        self.state = self.rng = self.feats = self.pset = None
        self._mine, self._extract = trainer.mine_proxies, trainer.extractor.extract
        trainer.mine_proxies, trainer.extractor.extract = self.mine, self.extract

    def mine(self, *a, use_momentum: bool = False, **kw):
        src = self.t.momentum if use_momentum else self.t.online
        self.state = {k: v.detach().clone() for k, v in src.state_dict().items()}
        self.rng = copy.deepcopy(self.t._rng)
        self.feats = None
        self.n += 1
        self.pset = self._mine(*a, use_momentum=use_momentum, **kw)
        return self.pset

    def extract(self, *a, **kw):
        self.feats = self._extract(*a, **kw)
        return self.feats


def _fault(run, trainer) -> None:
    """The benchmark's own tests break the timed path underneath."""
    if run.fault == "stale_state":
        trainer.optimizer.step = lambda *a, **kw: None
    elif run.fault == "half_batch":
        fb = trainer.forward_backward

        def half(images, labels, distortions, mask, *a, **kw):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
            return fb(images, labels, distortions, mask, *a, **kw)

        trainer.forward_backward = half
    elif run.fault == "altered_answer":
        aug = trainer.augment
        trainer.augment = lambda x: aug(x) * 1.05
    elif run.fault == "stale_mining":
        mine, first = trainer.mine_proxies, []

        def stale(*a, **kw):
            # later epochs reuse the first mining's centers and proxies
            if not first:
                first.append(mine(*a, **kw))
            return first[0]

        trainer.mine_proxies = stale


def run(run) -> None:
    # the tree's worker processes run while the program is imported and built
    with cf.ThreadPoolExecutor(1) as pool:
        tree = pool.submit(make_tree, run)
        from daliid_tpu_torch.data.registry import parse_market_duke_dir
        from daliid_tpu_torch.models.factory import ModelBundle
        from daliid_tpu_torch.train.sampler import PKBatchSampler
        from daliid_tpu_torch.train.trainer import Trainer

        p, cfg = run.params, run.config
        dev = torch.device(run.device)
        run.mark("imports")
        weights = models.make_weights(cfg, run.seed, dev)
        online = models.build_program(cfg, weights, dev)
        momentum = ModelBundle(module=copy.deepcopy(online.module),
                               feature_dim=online.feature_dim, name=online.name)
        run.mark("weights and models")
        root = tree.result()
    run.mark("tree")
    table = parse_market_duke_dir(os.path.join(root, "bounding_box_train"))
    table.name = "Market"
    sampler = PKBatchSampler(table, table.pids, P=p["P"], K=p["K"],
                             kind_of_transform=p["kind_of_transform"],
                             turbulence_dir=os.path.join(root, "turbulence"), dataset="Market",
                             seed=run.seed)
    tr = p["trainer"]
    trainer = Trainer(online, momentum, sampler, img_size=tuple(cfg["img_size"]),
                      base_lr=tr["base_lr"], weight_decay=tr["weight_decay"], tau=tr["tau"],
                      beta=tr["beta"], lambda_proxy=tr["lambda_proxy"],
                      num_epochs=tr["num_epochs"], num_proxies=tr["num_proxies"],
                      compute_dtype=getattr(torch, cfg["compute_dtype"]), seed=run.seed,
                      extractor_batch=tr["extractor_batch"])
    run.mark("trainer")
    _fault(run, trainer)
    rec = _Recorder(trainer, weights)
    try:
        trainer.train_epoch(1)
    except _WarmupDone:
        pass
    rec.restore()
    run.mark("warm-up: mining and the first steps")
    gc.collect()
    steps_per_epoch = sampler.batches_per_epoch()
    batch = sampler.batch_size
    mined = len(table)

    valid = [0]
    stage = trainer._stage

    def counted(b):
        valid[0] += int(b.mask.sum())
        return stage(b)

    trainer._stage = counted
    window_mining = _WindowMining(trainer)
    t0 = time.time()
    run.setup_s = t0 - run.t_start
    mining0 = trainer.timer.total("proxy_mining")
    epochs = 0
    with tracing.profiled(run.trace) as prof:
        while True:
            t_epoch, m_epoch = time.time(), trainer.timer.total("proxy_mining")
            trainer.train_epoch(2 + epochs)
            epochs += 1
            run.note(f"epoch {epochs}: {time.time() - t_epoch:.3f} s, mining "
                     f"{trainer.timer.total('proxy_mining') - m_epoch:.3f} s")
            if time.time() - t0 >= run.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        run.window_s = time.time() - t0
    if prof is not None:
        run.tracer = tracing.summarize(prof, run.window_s)
    images = epochs * steps_per_epoch * batch
    run.metrics["train_img_s"] = images / run.window_s
    run.spans["proxy_mining"] = trainer.timer.total("proxy_mining") - mining0
    run.counts.update(epochs=epochs, steps=epochs * steps_per_epoch, step_images=images,
                      valid_slots=valid[0], mined_images=epochs * mined, batch=batch,
                      mining_batches=epochs * -(-mined // tr["extractor_batch"]))
    run.shapes.update(k1=(batch, *cfg["img_size"]), extract_batch=tr["extractor_batch"],
                      attention=models.reference(cfg).attention(cfg))
    run.attempted = epochs * steps_per_epoch
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    program = dict(losses=rec.losses, aug=rec.aug, decoded=rec.decoded, grads=rec.grad_norms,
                   updates=rec.update_norms, ema=rec.ema_norms, feats=rec.feats,
                   pset=rec.pset, batches=rec.batches,
                   window=dict(minings=window_mining.n, epochs=epochs, feats=window_mining.feats,
                               pset=window_mining.pset, rng=window_mining.rng,
                               state=window_mining.state and {
                                   k: window_mining.state[k].float() for k in weights}))
    class_idx = np.asarray([sampler.label_to_class[l] for l in sampler.labels], np.int32)
    del trainer, online, momentum, rec, window_mining
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, table, class_idx, sampler.num_classes, weights, program)
    run.mark("the check")


def reference_side(run, weights: dict, batches: list, pset, prec: Precision,
                   decoded=None) -> dict:
    """The reference's first steps from ``weights`` on ``batches`` (its own
    decode of their JPEGs) with the mined ``pset`` (centers, proxies,
    labels) → the numbers the check compares; the first batch's
    augmentation also over ``decoded``, the program's bytes, if given."""
    cfg, tr = run.config, run.params["trainer"]
    dev = next(iter(weights.values())).device
    h, w = cfg["img_size"]
    rt = ref_train.ReferenceTrainer(models.reference(cfg), cfg, weights, tr, run.seed, prec)
    ps = tuple(torch.as_tensor(a, device=dev) for a in pset)
    out = dict(losses=[])
    for k, b in enumerate(batches):
        u8 = torch.from_numpy(ref_aug.decode(b.paths, h, w)).to(dev)
        if k == 0:
            # K1 judged on the bytes it was given: the first draw of the
            # augmentation's stream over the program's decoded batch
            given = u8 if decoded is None else decoded.to(dev)
            out["aug"] = ref_aug.augment(given, ref_aug.draw(
                *given.shape[:3], torch.Generator().manual_seed(run.seed)))
            out["decode_levels"] = int((given.int() - u8.int()).abs().max())
        run.mark(f"the check: decode and K1's reference, batch {k + 1}")
        loss, _ = rt.step(u8, torch.as_tensor(b.labels, device=dev),
                          torch.as_tensor(b.distortions, device=dev),
                          torch.as_tensor(b.mask, device=dev), ps, 1)
        run.mark(f"the check: the reference's step {k + 1}")
        out["losses"].append(loss)
        if k == 0:
            out["grads"] = {n: float(g.norm()) for n, g in rt.first_grads().items()}
    out["updates"] = {n: float((rt.P[n].detach() - weights[n]).norm()) for n in rt.params}
    out["ema"] = {n: float((rt.M[n] - weights[n]).norm()) for n in rt.params}
    return out


@torch.no_grad()
def reference_embed(run, weights: dict, paths, prec: Precision) -> np.ndarray:
    cfg = run.config
    h, w = cfg["img_size"]
    dev = next(iter(weights.values())).device
    out = []
    for i in range(0, len(paths), 128):
        x = ref_aug.normalize(torch.from_numpy(ref_aug.decode(paths[i:i + 128], h, w)).to(dev))
        out.append(models.reference(cfg).forward(cfg, weights, x, False, prec).float().cpu())
    return torch.cat(out).numpy()


def mining_gaps(run, table, class_idx, num_classes: int, weights: dict, feats, pset,
                rng: np.random.Generator, prec: Precision) -> tuple:
    """(worst row's gap, median row's gap, mined gap) of one mining: a
    seeded sample of its embeddings against the reference's from
    ``weights``, and what it mined against mining its embeddings again with
    ``rng``. For the control
    (``run.control``) the sample compared is the float8 reference's from the
    same weights."""
    rows = np.random.default_rng(run.seed).choice(len(table), run.params["check_rows"],
                                                  replace=False)
    paths = [str(table.paths[i]) for i in rows]
    ref = reference_embed(run, weights, paths, prec)
    got = (reference_embed(run, weights, paths, Precision("fp8")) if run.control
           else feats[rows])
    mined = ref_mining.mine(feats, class_idx, num_classes, run.params["trainer"]["num_proxies"],
                            rng)
    gaps = compare.row_gaps(got, ref)
    return float(gaps.max()), float(np.median(gaps)), compare.pset_gap(pset, mined)


def check(run, table, class_idx, num_classes: int, weights: dict, program: dict) -> None:
    """Compare the program's numbers with the reference's in float32."""
    set_strict_float32()
    prec = Precision("f32")
    ref = reference_side(run, weights, program["batches"], program["pset"][:3], prec,
                         program["decoded"])
    run.mark("the check: the reference's steps")
    run.note(f"decode: the program's bytes within {ref['decode_levels']} levels of PIL's")
    compare.train_numbers(run, program, ref)
    first = mining_gaps(run, table, class_idx, num_classes, weights, program["feats"],
                        program["pset"], np.random.default_rng(run.seed), prec)
    # every epoch of the window mined, and its last mining extracted
    win = program["window"]
    last = (float("inf"),) * 3
    if win["minings"] == win["epochs"] and win["feats"] is not None:
        last = mining_gaps(run, table, class_idx, num_classes, win["state"], win["feats"],
                           win["pset"], win["rng"], prec)
    run.mark("the check: the reference's embeddings")
    run.note(f"mining: epoch 1 embeddings {first[0]!r} (median row {first[1]!r}), mined "
             f"{first[2]!r}; the window's last ({win['minings']} minings in "
             f"{win['epochs']} epochs) embeddings {last[0]!r} (median row {last[1]!r}), "
             f"mined {last[2]!r}")
    run.check("mining_embed_gap", first[0])
    # the worst row after the window's steps swings from seed to seed in a
    # CNN (its trained BN statistics); a cell compares the median row there
    run.check("window_embed_gap", last[0])
    run.check("window_embed_median_gap", last[1])
    run.check("mining_pset_gap", max(first[2], last[2]))
