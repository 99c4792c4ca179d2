"""The training steps of ``trainBRDF.py`` and ``trainLight.py`` with
Adam(lr, betas=(0.5, 0.999), eps=1e-8), plain float32, and the readings
the benchmark compares: each step's loss, each leaf's first gradient and
each leaf's change over the steps taken."""

from __future__ import annotations

import torch

from bench_port.reference import sg
from bench_port.reference.imageops import pool_nhwc, to_nchw, to_nhwc
from bench_port.reference.scale import (
    brdf_errors,
    ls_regress,
    ls_regress_diff_spec,
    masked_sq_sum,
    mean_normalize,
)
from bench_port.reference.serve import light_input


class Adam:
    """torch.optim.Adam's update written out."""

    def __init__(self, params, lr=1e-4, betas=(0.5, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(self.eps),
                       value=-self.lr / c1)


def brdf_preds(nets, im):
    """NHWC maps of trainBRDF: albedo and depth in [0, 1]."""
    im_c = to_nchw(im)
    out = nets(im_c, im_c)
    return {k: to_nhwc(0.5 * (v + 1.0) if k in ("albedo", "depth") else v)
            for k, v in out.items()}


def brdf_loss(nets, batch, weights=(1.5, 1.0, 0.5, 0.5)):
    e = brdf_errors(**brdf_preds(nets, batch["im"]), batch=batch)
    aw, nw, rw, dw = weights
    return (4.0 * aw * e["albedo"] + nw * e["normal"] + rw * e["rough"]
            + dw * e["depth"])


def envmap_reconst_error(env_pred, env_gt, seg_env, offset=1.0):
    """Log-space masked envmap error, the prediction fitted onto the
    ground truth first; env [B,r,c,D,3], seg_env [B,r,c,1]."""
    seg5 = seg_env[..., None, :]
    scaled = ls_regress(env_pred.detach() * seg5, env_gt * seg5, env_pred)
    num = torch.sum((torch.log(scaled + offset)
                     - torch.log(env_gt + offset)) ** 2 * seg5)
    return (num / torch.clamp(torch.sum(seg_env), min=1e-5) / 3.0
            / env_pred.shape[-2])


def render_error(diffuse, specular, im_small, seg_small):
    """The shading fitted onto the pooled image (on detached inputs), the
    sum clamped to [0, 1], then the masked squared error."""
    d, s = ls_regress_diff_spec(diffuse.detach(), specular.detach(),
                                im_small, diffuse, specular)
    return masked_sq_sum(torch.clamp(d + s, 0.0, 1.0), im_small, seg_small,
                         3.0)


def light_loss(brdf, light, batch, reconst_w=10.0, render_w=1.0,
               offset=1.0, fov=57.0):
    """trainLight's loss: the frozen BRDF nets' maps (albedo and depth
    mean-normalized) into the light nets, reconst_w times the envmap
    error plus render_w times the rendering error on the lighting
    grid."""
    with torch.no_grad():
        preds = brdf_preds(brdf, batch["im"])
    preds["albedo"] = mean_normalize(preds["albedo"])
    preds["depth"] = mean_normalize(preds["depth"])
    r, c = light.env_rows, light.env_cols
    eh, ew, k = light.env_height, light.env_width, light.sg_num
    im = batch["im"]
    inp = light_input(to_nchw(im), {n: to_nchw(v) for n, v in preds.items()},
                      (4 * r, 4 * c))
    out = {n: to_nhwc(v) for n, v in light(inp, (r, c)).items()}
    b = im.shape[0]
    axis = out["axis"].reshape(b, r, c, k, 3)
    lamb = sg.unsquash(out["lamb"])
    weight = sg.unsquash(out["weight"]).reshape(b, r, c, k, 3)
    im_small = pool_nhwc(im, (r, c))
    seg_small = pool_nhwc(batch["seg_brdf"], (r, c))
    env_gt = batch["env_gt"]
    not_dark = (torch.mean(env_gt, dim=(-2, -1))[..., None] > 0.001).float()
    seg_env = seg_small * batch["env_ind"].reshape(-1, 1, 1, 1) * not_dark
    env_pred = sg.sg_to_envmap(axis, lamb, weight, eh, ew)
    reconst = envmap_reconst_error(env_pred, env_gt, seg_env, offset)
    diffuse, specular = sg.render_envmap(
        pool_nhwc(preds["albedo"], (r, c)), pool_nhwc(preds["normal"], (r, c)),
        pool_nhwc(preds["rough"], (r, c)), env_pred, fov, eh, ew)
    render = render_error(diffuse, specular, im_small, seg_small)
    return reconst_w * reconst + render_w * render


def leaf_norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def run_steps(trained, loss_fn, batches, lr=1e-4, moments=None):
    """Adam on the parameters of ``trained`` through ``loss_fn(batch)``
    over ``batches``, from fresh moments or from ``moments`` ({"m": [per
    leaf], "v": [per leaf], "t": steps taken}).  Returns {"loss": [per
    step], "grad": [per leaf, the first step's gradient norm], "change":
    [per leaf, the norm of the change over all steps]}; leaves in
    ``named_parameters`` order."""
    params = [p for _, p in trained.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = Adam(params, lr=lr)
    if moments is not None:
        opt.m = [m.clone() for m in moments["m"]]
        opt.v = [v.clone() for v in moments["v"]]
        opt.t = moments["t"]
    losses, grads = [], None
    for batch in batches:
        for p in params:
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        if grads is None:
            grads = leaf_norms(p.grad for p in params)
        opt.step()
        losses.append(float(loss.detach()))
    change = leaf_norms(p.detach() - s for p, s in zip(params, start))
    return {"loss": losses, "grad": grads, "change": change}
