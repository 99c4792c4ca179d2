"""The nets of the published model, NCHW, float32: MGNet's encoder and
decoders (``models.py`` encoder0 / decoder0), LightNet's encoder and SG
decoders (encoderLight / decoderLight) and the bilateral solver's
confidence CNN (``BilateralLayer.py``).

Parameter names are the published checkpoints' (``conv{i}``/``gn{i}``,
``dconv{i}``/``dgn{i}``/``dconvFinal``, ``preProcess.1/.2/.5/.6``), so one
state dict loads into these modules and into the measured program's.
Every convolution goes through the bundle's ``conv`` function (see the
package docstring); GroupNorm runs in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port.reference.imageops import (
    replication_pad,
    resize_bilinear,
    upsample2x,
)

GN_EPS = 1e-5


def conv_f32(x, weight, bias, stride, padding):
    return F.conv2d(x, weight, bias, stride, padding)


CONV_F32 = conv_f32


def conv_bf16(x, weight, bias, stride, padding):
    """A bfloat16 convolution as a bfloat16 configuration states it:
    input, kernel and bias cast per call, the output back to float32."""
    b16 = torch.bfloat16
    return F.conv2d(x.to(b16), weight.to(b16),
                    None if bias is None else bias.to(b16), stride,
                    padding).float()


CONV_BF16 = conv_bf16

# (out, groups, kernel, stride, edge pad) of the encoders' six convs
MG_ENC = ((64, 4, 4, 2, True), (128, 8, 4, 2, False), (256, 16, 4, 2, False),
          (256, 16, 4, 2, False), (512, 32, 4, 2, False),
          (1024, 64, 3, 1, False))
MG_DEC = ((512, 32), (256, 16), (256, 16), (128, 8), (64, 4), (64, 4))
MG_SKIPS = (512, 256, 256, 128, 64)
LIGHT_ENC = ((128, 8, 4, 2, True), (256, 16, 4, 2, False),
             (256, 16, 4, 2, False), (512, 32, 4, 2, False),
             (512, 32, 4, 2, False), (1024, 64, 3, 1, False))
LIGHT_DEC = ((512, 32), (512, 32), (256, 16), (256, 16), (128, 8), (128, 8))
LIGHT_SKIPS = (512, 512, 256, 256, 128)
BRDF_HEADS = {"albedo": 0, "normal": 1, "rough": 2, "depth": 4}
SG_HEADS = {"axis": 0, "lamb": 1, "weight": 2}
BS_MODES = {"albedo": 6, "rough": 4, "depth": 4}


def block(conv, x, gn: nn.GroupNorm, c: nn.Conv2d, edge_pad: bool):
    """pad -> conv -> GroupNorm -> ReLU."""
    if edge_pad:
        x = replication_pad(x, 1)
    y = conv(x, c.weight, c.bias, c.stride, c.padding)
    return F.relu(F.group_norm(y, gn.num_groups, gn.weight, gn.bias, gn.eps))


def add_convs(mod: nn.Module, spec, cin: int, prefix=("conv", "gn")):
    for i, (cout, groups, k, s, edge) in enumerate(spec, start=1):
        setattr(mod, f"{prefix[0]}{i}",
                nn.Conv2d(cin, cout, k, s, padding=0 if edge else 1))
        setattr(mod, f"{prefix[1]}{i}", nn.GroupNorm(groups, cout, eps=GN_EPS))
        cin = cout


def run_encoder(conv, mod, spec, x):
    feats = []
    for i, s in enumerate(spec, start=1):
        x = block(conv, x, getattr(mod, f"gn{i}"), getattr(mod, f"conv{i}"),
                  s[4])
        feats.append(x)
    return feats


class Encoder(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        add_convs(self, MG_ENC, cin)

    def forward(self, conv, x):
        return run_encoder(conv, self, MG_ENC, x)


class Trunk(nn.Module):
    """The U-Net decoder trunk: block 1 on the deepest map, then for each
    skip: concat, 2x upsample, conv block, resize to the next skip."""

    def __init__(self, spec, skips, out_final: int):
        super().__init__()
        cin = 1024
        for i, (cout, groups) in enumerate(spec, start=1):
            setattr(self, f"dconv{i}", nn.Conv2d(cin, cout, 3, 1, padding=1))
            setattr(self, f"dgn{i}", nn.GroupNorm(groups, cout, eps=GN_EPS))
            if i <= len(skips):
                cin = cout + skips[i - 1]
        self.nblocks = len(spec)
        self.dconvFinal = nn.Conv2d(spec[-1][0], out_final, 3, 1, padding=0)

    def trunk(self, conv, out_hw, feats):
        skips = list(feats[:-1])
        x = block(conv, feats[-1], self.dgn1, self.dconv1, False)
        for i in range(2, self.nblocks + 1):
            skip = skips.pop()
            x = upsample2x(torch.cat([x, skip], dim=1))
            x = block(conv, x, getattr(self, f"dgn{i}"),
                      getattr(self, f"dconv{i}"), False)
            hw = skips[-1].shape[-2:] if skips else out_hw
            if tuple(x.shape[-2:]) != tuple(hw):
                x = resize_bilinear(x, hw)
        f = self.dconvFinal
        return conv(replication_pad(x, 1), f.weight, f.bias, f.stride,
                    f.padding)


class Decoder(Trunk):
    def __init__(self, mode: int):
        super().__init__(MG_DEC, MG_SKIPS, 3)
        self.mode = mode

    def forward(self, conv, im, feats):
        x = self.trunk(conv, im.shape[-2:], feats)
        if self.mode == 4:
            x = torch.mean(x, dim=1, keepdim=True)
            return torch.clamp(1.01 * torch.tanh(x), -1.0, 1.0)
        x = torch.clamp(1.01 * torch.tanh(x), -1.0, 1.0)
        if self.mode == 1:
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            return x / torch.clamp(norm, min=1e-6)
        if self.mode == 2:
            return torch.mean(x, dim=1, keepdim=True)
        return x


class BRDFNets(nn.Module):
    """Encoder + albedo / normal / rough / depth decoders of one cascade."""

    def __init__(self, cascade_level: int = 0, conv=CONV_F32):
        super().__init__()
        self.cascade_level = cascade_level
        self.conv = conv
        self.encoder = Encoder(3 if cascade_level == 0 else 17)
        for name, mode in BRDF_HEADS.items():
            setattr(self, name, Decoder(mode))

    def forward(self, im, inp):
        feats = self.encoder(self.conv, inp)
        return {n: getattr(self, n)(self.conv, im, feats) for n in BRDF_HEADS}


class LightEncoder(nn.Module):
    def __init__(self, sg_num: int, cascade_level: int):
        super().__init__()
        self.cascade_level = cascade_level
        self.preProcess = nn.Sequential(
            nn.ReplicationPad2d(1), nn.Conv2d(11, 32, 4, 2),
            nn.GroupNorm(2, 32, eps=GN_EPS), nn.ReLU(), nn.ZeroPad2d(1),
            nn.Conv2d(32, 64, 4, 2), nn.GroupNorm(4, 64, eps=GN_EPS),
            nn.ReLU())
        add_convs(self, LIGHT_ENC,
                  64 + (sg_num * 7 if cascade_level > 0 else 0))

    def forward(self, conv, x, env_pre=None):
        pp = self.preProcess
        h = block(conv, x, pp[2], pp[1], True)
        h = block(conv, F.pad(h, (1, 1, 1, 1)), pp[6], pp[5], False)
        if self.cascade_level > 0:
            h = torch.cat([h, env_pre], dim=1)
        return run_encoder(conv, self, LIGHT_ENC, h)


class LightDecoder(Trunk):
    def __init__(self, sg_num: int, mode: int):
        super().__init__(LIGHT_DEC, LIGHT_SKIPS,
                         sg_num if mode == 1 else 3 * sg_num)
        self.sg_num, self.mode = sg_num, mode

    def forward(self, conv, feats, env_hw):
        x = 1.01 * torch.tanh(self.trunk(conv, env_hw, feats))
        if self.mode in (1, 2):
            return torch.clamp(0.5 * (x + 1.0), 0.0, 1.0)
        b, _, h, w = x.shape
        x = x.reshape(b, self.sg_num, 3, h, w)
        norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
        return (x / torch.clamp(norm, min=1e-6)).reshape(b, -1, h, w)


class LightNets(nn.Module):
    def __init__(self, sg_num: int = 12, cascade_level: int = 0,
                 env_rows: int = 120, env_cols: int = 160,
                 env_height: int = 8, env_width: int = 16, conv=CONV_F32):
        super().__init__()
        self.sg_num, self.cascade_level = sg_num, cascade_level
        self.env_rows, self.env_cols = env_rows, env_cols
        self.env_height, self.env_width = env_height, env_width
        self.conv = conv
        self.encoder = LightEncoder(sg_num, cascade_level)
        for name, mode in SG_HEADS.items():
            setattr(self, name, LightDecoder(sg_num, mode))

    def forward(self, inp, env_hw, env_pre=None):
        feats = self.encoder(self.conv, inp, env_pre)
        return {n: getattr(self, n)(self.conv, feats, env_hw)
                for n in SG_HEADS}


class ConfidenceNet(nn.Module):
    FEATS = 16

    def __init__(self, cin: int):
        super().__init__()
        f = self.FEATS
        self.conv1 = nn.Conv2d(cin, f, 4, 2)
        self.gn1 = nn.GroupNorm(2, f, eps=GN_EPS)
        self.conv2 = nn.Conv2d(f, f, 4, 2)
        self.gn2 = nn.GroupNorm(2, f, eps=GN_EPS)
        self.dconv1 = nn.Conv2d(f, f, 3, 1, padding=1)
        self.dgn1 = nn.GroupNorm(2, f, eps=GN_EPS)
        self.dconv2 = nn.Conv2d(2 * f, f, 3, 1, padding=1)
        self.dgn2 = nn.GroupNorm(2, f, eps=GN_EPS)
        self.dconvFinal = nn.Conv2d(f, 1, 3, 1)

    def forward(self, conv, image, pred):
        """image [B,3,H,W], pred [B,C,H,W] -> confidence [B,1,H,W] divided
        by its maximum over the whole batch (BilateralLayer.py:246-269)."""
        b = image.shape[0]
        scale = torch.clamp(torch.amax(image.reshape(b, -1), dim=1),
                            1e-5, 1.0).reshape(b, 1, 1, 1)
        x = torch.cat([image / scale, pred], dim=1)
        x1 = block(conv, replication_pad(x, 1), self.gn1, self.conv1, False)
        x2 = block(conv, replication_pad(x1, 1), self.gn2, self.conv2, False)
        dx1 = block(conv, x2, self.dgn1, self.dconv1, False)
        dx1 = resize_bilinear(dx1, x1.shape[-2:])
        dx2 = block(conv, torch.cat([dx1, x1], dim=1), self.dgn2,
                    self.dconv2, False)
        dx2 = resize_bilinear(dx2, x.shape[-2:])
        f = self.dconvFinal
        out = conv(replication_pad(dx2, 1), f.weight, f.bias, f.stride,
                   f.padding)
        conf = 0.5 * (torch.tanh(out) + 1.0)
        return conf / torch.clamp(torch.amax(conf), min=1e-5)


class BilateralNets(nn.Module):
    def __init__(self, conv=CONV_F32):
        super().__init__()
        self.conv = conv
        for name, cin in BS_MODES.items():
            setattr(self, name, ConfidenceNet(cin))

    def confidence(self, name, im_nchw, target_nchw):
        return getattr(self, name)(self.conv, im_nchw, target_nchw)
