"""Driver of serving traffic: one client in a closed loop through the
program's fused ``InverseRenderer`` at level 2 with lighting and the
bilateral refinement (``testReal.py --level 2 --isLight --isBS``),
``batch`` photos a call, over a pool of seeded photos, cycled.

A request is timed by the host clock from the call to its outputs,
synchronised.  The outputs of a sample of requests (the window's first,
and ``sample`` drawn from the seed among the first ``sample_from``) are
copied to the host after their timing.  After the window the reference
computes each stage of each sampled call from its photos and the
program's own outputs of the stages before it (``reference.serve.
stages``), and the numbers of ``compare_photo`` are compared, each the
worst over the sample's photos and both levels.
"""

from __future__ import annotations

import gc
import time

import torch

from bench_port import flops, harness, peaks, program
from bench_port.reference import bilateral as RB
from bench_port.reference import precision
from bench_port.reference import serve as RS
from bench_port.traffic.photos import make_photos
from bench_port.weights import generator

FOV = 57.0
MAPS = ("albedo", "normal", "rough", "depth")
REFINED = ("albedo", "rough", "depth")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def _scale(c, j):
    return float(c[j]) if isinstance(c, torch.Tensor) else float(c)


def shape_gap(got: torch.Tensor, raw: torch.Tensor):
    """How far ``got`` lies from the nearest multiple of ``raw``, over
    the norm of ``got`` (None where ``got`` is zero: the fit dropped the
    component)."""
    got, raw = got.double().flatten(), raw.double().flatten()
    norm = float(torch.linalg.vector_norm(got))
    if norm == 0.0:
        return None
    den = float(torch.dot(raw, raw))
    a = float(torch.dot(got, raw)) / den if den > 0.0 else 0.0
    return float(torch.linalg.vector_norm(got - a * raw)) / norm


def compare_photo(got: dict, j: int, want: dict) -> dict:
    """The numbers of row ``j`` of an output against row ``j`` of the
    reference's, the worst of both levels: ``maps`` (albedo, normal,
    rough, depth), ``sg`` (the SG parameters), ``env`` (the decoded
    envmaps before the scale cLight), ``render`` (the diffuse and the
    specular shading before the fit: the output, a per-image multiple of
    it, against the nearest multiple of the reference's), ``refined``
    (albedo, rough, depth); and the outputs of the fit: ``shading``
    (diffuse, specular), ``scales`` (cAlbedo, cLight) and ``env_scaled``
    (the envmaps after cLight)."""
    rel = program.rel_l2
    out = {}
    for lvl in (0, 1):
        gp, wp = got["preds"][lvl], want["preds"][lvl]
        gl, wl = got["lights"][lvl], want["lights"][lvl]
        gr, wr = got["refined"][lvl], want["refined"][lvl]
        gaps = [shape_gap(gl[k][j], wl[k + "_raw"][j].cpu())
                for k in ("diffuse", "specular")]
        row = {
            "maps": max(rel(gp[k][j], wp[k][j].cpu()) for k in MAPS),
            "sg": rel(gl["sg_flat"][j], wl["sg_flat"][j].cpu()),
            "env": rel(gl["env_img"][j] / _scale(gl["c_light"], j),
                       wl["env"][j].cpu()),
            "render": max([g for g in gaps if g is not None], default=0.0),
            "env_scaled": rel(gl["env_img"][j], wl["env_img"][j].cpu()),
            "shading": max(rel(gl[k][j], wl[k][j].cpu())
                           for k in ("diffuse", "specular")),
            "scales": max(abs(_scale(gl[k], j) - float(wl[k][j]))
                          / max(abs(float(wl[k][j])), 1e-30)
                          for k in ("c_albedo", "c_light")),
            "refined": max(rel(gr[k][j], wr[k][j].cpu()) for k in REFINED),
        }
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


class Session:

    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed = spec, seed
        self.device = torch.device(device)
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.batch = self.traffic["batch"]
        self.failed = 0
        self.call_ms, self.kept = [], {}
        self.nvert = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def photos(self):
        cfg = self.cfg
        return make_photos(self.seed, self.traffic["pool"],
                           (cfg["im_height"], cfg["im_width"]),
                           (cfg["env_rows"], cfg["env_cols"]),
                           (cfg["env_height"], cfg["env_width"]), self.device)

    def photo_ids(self, i: int) -> list:
        n = self.traffic["pool"]
        return [(i * self.batch + j) % n for j in range(self.batch)]

    def make_inputs(self) -> None:
        """The photo pool, each call's inputs, and the sampled calls."""
        tr = self.traffic
        self.im, self.small = self.photos()
        self.inputs = [(self.im[ids].contiguous(),
                        self.small[ids].contiguous())
                       for ids in (self.photo_ids(i)
                                   for i in range(tr["pool"] // self.batch))]
        g = generator("cpu", self.seed, "sample")
        # the window's first call, and calls drawn from the seed
        self.sample = {0} | set(torch.randperm(tr["sample_from"], generator=g)[
            :tr["sample"]].tolist())

    def setup(self) -> None:
        from inverserenderingofindoorscene_torch.pipeline.inference import (
            InverseRenderer,
        )

        cfg, tr = self.cfg, self.traffic
        log = harness.PhaseLog(self._sync)
        program.set_backends(cfg)
        self.make_inputs()
        log("inputs")
        n_calls = len(self.inputs)

        def port(kind, level):
            return program.port(kind, level, cfg, self.device, self.seed,
                                cfg["compute_dtype"] if kind != "bs"
                                else "float32")

        stacks = [(port("brdf", lvl), port("light", lvl)) for lvl in (0, 1)]
        bs = [port("bs", lvl) for lvl in (0, 1)]
        self.renderer = InverseRenderer(
            stacks, is_light=True, is_bs=True, bs_nets=bs,
            use_kernels=True, fused=True, device=self.device)
        log("program")
        for i in range(tr["warm_calls"]):
            self.renderer(*self.inputs[i % n_calls], FOV)
            log(f"call {i + 1}")
        self.first_index = 0
        self.setup_log = log.text()

    def call(self, i: int) -> int:
        im, small = self.inputs[i % len(self.inputs)]
        c0 = time.perf_counter()
        out = self.renderer(im, small, FOV)
        self._sync()
        self.call_ms.append((time.perf_counter() - c0) * 1e3)
        if i in self.sample:
            self.kept[i] = _host(out)
        return self.batch

    def end_window(self) -> None:
        pass

    def end_to_end(self, window) -> dict:
        return {"serve_img_per_s": window.images / window.elapsed}

    def free_program(self) -> None:
        del self.renderer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------
    def _stacks(self, conv=None):
        cfg = self.cfg
        kw = {} if conv is None else {"conv": conv}

        def ref(kind, lvl):
            return program.reference(kind, lvl, cfg, self.device, self.seed,
                                     **kw)

        return ([(ref("brdf", lvl), ref("light", lvl)) for lvl in (0, 1)],
                [ref("bs", lvl) for lvl in (0, 1)])

    def _prev(self, got):
        """An output's maps and lighting, on the device."""
        def dev(d):
            return {k: v.to(self.device) for k, v in d.items()
                    if isinstance(v, torch.Tensor) and v.dim() > 1}

        return {"preds": [dev(d) for d in got["preds"]],
                "lights": [dev(d) for d in got["lights"]]}

    def _record_nvert(self, i, nvert):
        for j, p in enumerate(self.photo_ids(i)):
            self.nvert[p] = [{m: v[j] for m, v in lvl.items()}
                             for lvl in nvert]

    def check(self, conv=None, all_photos=False) -> dict:
        """The numbers over the sampled calls' photos, each stage
        judged on the judged side's own inputs to it (``RS.stages``, on
        the call's whole batch: the confidences are divided by their
        maximum over the batch): the program's outputs, or, with
        ``conv``, those of the reference computed with that convolution
        and its rounding of the shading's sums (a control), each against
        the reference.  ``all_photos`` also
        records every pool photo's vertex counts (for the blur's
        roofline)."""
        # the refinement's CG turns a last-bit difference in its
        # confidences into ~1e-4 in the refined maps (its channels stop at
        # a tolerance): the reference's convolutions take the algorithms
        # cuDNN timed for the program's shapes, so that each stage is
        # judged on its own arithmetic
        program.reference_backends(self.cfg["cudnn_benchmark"])
        stacks, bs = self._stacks()
        if conv is None:
            cases = [(self.kept[i], i) for i in sorted(self.kept)]
        else:
            c_stacks, c_bs = self._stacks(conv)
            rounding = precision.ROUNDING[conv]
            cases = [(_host(RS.serve(c_stacks, c_bs, *self.inputs[
                i % len(self.inputs)], FOV, rounding)), i)
                for i in sorted(self.sample)]
        result = {}
        for got, i in cases:
            im, small = self.inputs[i % len(self.inputs)]
            want = RS.stages(stacks, bs, im, small, FOV, self._prev(got))
            self._record_nvert(i, want["nvert"])
            for j in range(self.batch):
                for k, v in compare_photo(got, j, want).items():
                    result[k] = max(result.get(k, 0.0), v)
        if all_photos:
            for i in range(len(self.inputs)):
                if any(p not in self.nvert for p in self.photo_ids(i)):
                    self._record_nvert(i, RS.serve(
                        stacks, bs, *self.inputs[i], FOV)["nvert"])
        return result

    # -- per-layer context ---------------------------------------------
    def model_flops_per_image(self) -> float:
        return flops.serve_flops(self.cfg, 1)

    def kernel_bounds(self, card: str, calls: list) -> dict:
        """{wrapper: (launches, bound s)} of the requests ``calls``: two
        ``render_sg_env`` a request; each photo's 68 blurs a level on its
        reference grids (11 of one channel to bistochastize, 1 + the CG
        iterations of the map's channels to solve)."""
        cfg = self.cfg
        shape = (self.batch, cfg["env_rows"], cfg["env_cols"],
                 cfg["sg_num"], cfg["env_height"] * cfg["env_width"])
        env = peaks.kernel_bound_s(card, *flops.render_sg_env(*shape))
        out = {"render_sg_env": (2 * len(calls), 2 * len(calls) * env)}
        blur_n = blur_s = 0
        channels = {"albedo": 3, "rough": 1, "depth": 1}
        for i in calls:
            for p in self.photo_ids(i):
                if p not in self.nvert:
                    return out
                for lvl in (0, 1):
                    for mode, params in RB.MODES.items():
                        v = self.nvert[p][lvl][mode]
                        solve = 1 + params.cg_maxiter
                        blur_n += 11 + solve
                        blur_s += 11 * peaks.kernel_bound_s(
                            card, *flops.bilateral_blur(v, 1))
                        blur_s += solve * peaks.kernel_bound_s(
                            card, *flops.bilateral_blur(v, channels[mode]))
        out["bilateral_blur"] = (blur_n, blur_s)
        return out
