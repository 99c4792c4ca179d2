"""Faults planted under the timed path, each of which the comparison has
to catch (``correct`` false).  Each is a function of a session, applied
before its set-up; the benchmark's tests drive a run with each on the
CPU, and ``calibrate.py --fault`` reads them on the card.

* ``unchanged``: the training step returns its state unchanged (the
  optimizer's update does nothing);
* ``half_batch``: half of each batch left out, the step's mean taken
  over the rest; in serving, half of a call's photos served and their
  answers handed out for the other half too;
* ``altered``: an answer altered where it is produced (the served
  cascade-0 albedo scaled by 1.01);
* ``shading``: the shading altered where it is produced (the render
  kernel's diffuse and specular scaled by 1.01 over the top half of the
  lighting grid);
* ``window_unchanged``, ``window_half_batch``: ``unchanged`` and
  ``half_batch`` from the window's first step on, after set-up's steps.
"""

from __future__ import annotations

import torch


class _Half:
    def __init__(self, step):
        self.step, self.optimizer = step, step.optimizer

    def __call__(self, batch):
        return self.step({k: v[:max(1, v.shape[0] // 2)]
                          for k, v in batch.items()})


def _after(session, name, wrap):
    inner = getattr(session, name)

    def hooked():
        out = inner()
        return wrap(out)

    setattr(session, name, hooked)


def unchanged(session):
    def wrap(out):
        step, trained = out
        step.optimizer.step = lambda *a, **k: None
        return step, trained

    _after(session, "program_step", wrap)


def _twice(x, h):
    if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] == h:
        return torch.cat([x, x])
    if isinstance(x, dict):
        return {k: _twice(v, h) for k, v in x.items()}
    if isinstance(x, list):
        return [_twice(v, h) for v in x]
    return x


class _HalfServe:
    def __init__(self, renderer):
        self.renderer = renderer

    def __call__(self, im, small, fov):
        h = im.shape[0] // 2
        return _twice(self.renderer(im[:h], small[:h], fov), h)


class _Altered:
    def __init__(self, renderer):
        self.renderer = renderer

    def __call__(self, im, small, fov):
        out = self.renderer(im, small, fov)
        out["preds"][0]["albedo"] = out["preds"][0]["albedo"] * 1.01
        return out


class _Shaded:
    def __init__(self, renderer):
        self.renderer = renderer

    def __call__(self, im, small, fov):
        from inverserenderingofindoorscene_torch.pipeline import inference

        inner = inference.render_sg_env

        def render(*args, **kwargs):
            diffuse, specular, env = inner(*args, **kwargs)
            top = torch.ones_like(diffuse[:, :, :1, :1])
            top[:, :diffuse.shape[1] // 2] = 1.01
            return diffuse * top, specular * top, env

        inference.render_sg_env = render
        try:
            return self.renderer(im, small, fov)
        finally:
            inference.render_sg_env = inner


def half_batch(session):
    if hasattr(session, "program_step"):
        def wrap(out):
            step, trained = out
            return _Half(step), trained

        _after(session, "program_step", wrap)
        return
    inner = session.setup

    def setup():
        inner()
        session.renderer = _HalfServe(session.renderer)

    session.setup = setup


def _wrap_renderer(session, wrapper):
    inner = session.setup

    def setup():
        inner()
        session.renderer = wrapper(session.renderer)

    session.setup = setup


def altered(session):
    _wrap_renderer(session, _Altered)


def shading(session):
    _wrap_renderer(session, _Shaded)


def _in_window(fault):
    """``fault`` planted once set-up has taken its steps."""
    def plant(session):
        inner = session.setup

        def setup():
            inner()
            probe = type("Probe", (), {})()
            probe.program_step = lambda: (session.step, None)
            fault(probe)
            session.step, _ = probe.program_step()

        session.setup = setup

    return plant


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "shading": shading,
          "window_unchanged": _in_window(unchanged),
          "window_half_batch": _in_window(half_batch)}
