"""Inception-v3 backbone of WS-DAN/CAL with its two truncation points
(counterpart of saspa_tpu/models/inception.py).

Reference: fgvc/models/inception.py, get_features_mixed_6e (768 channels)
and get_features_mixed_7c (2048), selected by net='inception_mixed_6e' /
'inception_mixed_7c' (fgvc/models/cal.py:140-147).  NCHW, with the flax
tree's names (`Conv2d_1a_3x3`, `Mixed_5b`, `branch7x7dbl_3`, `conv`, `bn`),
so the bridge loads the JAX package's variables as they are.  Convolutions
are VALID unless a padding is given, as flax's default; the pooling branch
averages a 3x3 window over zero padding that counts in the mean
(count_include_pad); max pools are 3x3 stride 2 VALID.  Branches
concatenate on the channels in the JAX module's order.  forward(x) runs
BatchNorm (eps 1e-3) with its running statistics, forward(x, train=True)
with the batch's, updating the running ones.  `param_dtype=torch.float32`
keeps f32 master weights for training.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import BatchNorm, Conv

NUM_FEATURES_INCEPTION = {"inception_mixed_6e": 768, "inception_mixed_7c": 2048}


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3) -> ReLU."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride=stride, padding=padding, dtype=dtype, device=device,
                         bias=False, param_dtype=param_dtype)
        self.bn = BatchNorm(out_ch, eps=1e-3, device=device)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


def _avg_pool_3x3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2)


class _Block(nn.Module):
    """Holds the branches as BasicConv2d children named as flax's."""

    def __init__(self, specs, **kw):
        super().__init__()
        for name, (cin, cout, kernel, stride, padding) in specs.items():
            setattr(self, name, BasicConv2d(cin, cout, kernel, stride, padding, **kw))

    def chain(self, x, names, train):
        for n in names:
            x = getattr(self, n)(x, train)
        return x


class InceptionA(_Block):
    def __init__(self, cin, pool_features, **kw):
        super().__init__({"branch1x1": (cin, 64, 1, 1, 0), "branch5x5_1": (cin, 48, 1, 1, 0),
                          "branch5x5_2": (48, 64, 5, 1, 2), "branch3x3dbl_1": (cin, 64, 1, 1, 0),
                          "branch3x3dbl_2": (64, 96, 3, 1, 1), "branch3x3dbl_3": (96, 96, 3, 1, 1),
                          "branch_pool": (cin, pool_features, 1, 1, 0)}, **kw)

    def forward(self, x, train: bool = False):
        return torch.cat([self.branch1x1(x, train), self.chain(x, ("branch5x5_1", "branch5x5_2"), train),
                          self.chain(x, ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"), train),
                          self.branch_pool(_avg_pool_3x3(x), train)], dim=1)


class InceptionB(_Block):
    def __init__(self, cin, **kw):
        super().__init__({"branch3x3": (cin, 384, 3, 2, 0), "branch3x3dbl_1": (cin, 64, 1, 1, 0),
                          "branch3x3dbl_2": (64, 96, 3, 1, 1), "branch3x3dbl_3": (96, 96, 3, 2, 0)}, **kw)

    def forward(self, x, train: bool = False):
        return torch.cat([self.branch3x3(x, train),
                          self.chain(x, ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"), train),
                          _max_pool_3x3_s2(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin, c7, **kw):
        row, col = (0, 3), (3, 0)  # (1, 7) and (7, 1) kernels: flax's ((0, 0), (3, 3)) and ((3, 3), (0, 0))
        super().__init__({"branch1x1": (cin, 192, 1, 1, 0), "branch7x7_1": (cin, c7, 1, 1, 0),
                          "branch7x7_2": (c7, c7, (1, 7), 1, row), "branch7x7_3": (c7, 192, (7, 1), 1, col),
                          "branch7x7dbl_1": (cin, c7, 1, 1, 0), "branch7x7dbl_2": (c7, c7, (7, 1), 1, col),
                          "branch7x7dbl_3": (c7, c7, (1, 7), 1, row), "branch7x7dbl_4": (c7, c7, (7, 1), 1, col),
                          "branch7x7dbl_5": (c7, 192, (1, 7), 1, row), "branch_pool": (cin, 192, 1, 1, 0)}, **kw)

    def forward(self, x, train: bool = False):
        dbl = ("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5")
        return torch.cat([self.branch1x1(x, train), self.chain(x, ("branch7x7_1", "branch7x7_2", "branch7x7_3"), train),
                          self.chain(x, dbl, train), self.branch_pool(_avg_pool_3x3(x), train)], dim=1)


class InceptionD(_Block):
    def __init__(self, cin, **kw):
        super().__init__({"branch3x3_1": (cin, 192, 1, 1, 0), "branch3x3_2": (192, 320, 3, 2, 0),
                          "branch7x7x3_1": (cin, 192, 1, 1, 0), "branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
                          "branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)), "branch7x7x3_4": (192, 192, 3, 2, 0)}, **kw)

    def forward(self, x, train: bool = False):
        b7 = ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4")
        return torch.cat([self.chain(x, ("branch3x3_1", "branch3x3_2"), train), self.chain(x, b7, train),
                          _max_pool_3x3_s2(x)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin, **kw):
        super().__init__({"branch1x1": (cin, 320, 1, 1, 0), "branch3x3_1": (cin, 384, 1, 1, 0),
                          "branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)), "branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
                          "branch3x3dbl_1": (cin, 448, 1, 1, 0), "branch3x3dbl_2": (448, 384, 3, 1, 1),
                          "branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)),
                          "branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)), "branch_pool": (cin, 192, 1, 1, 0)}, **kw)

    def forward(self, x, train: bool = False):
        b3 = self.branch3x3_1(x, train)
        b3 = torch.cat([self.branch3x3_2a(b3, train), self.branch3x3_2b(b3, train)], dim=1)
        bd = self.chain(x, ("branch3x3dbl_1", "branch3x3dbl_2"), train)
        bd = torch.cat([self.branch3x3dbl_3a(bd, train), self.branch3x3dbl_3b(bd, train)], dim=1)
        return torch.cat([self.branch1x1(x, train), b3, bd, self.branch_pool(_avg_pool_3x3(x), train)], dim=1)


class InceptionV3Features(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, 768, ~H/16, ~W/16) truncated at
    mixed_6e, or (B, 2048, ~H/32, ~W/32) at mixed_7c; H, W >= 75."""

    def __init__(self, truncate_at: str = "mixed_6e", dtype=torch.float32, device=None, param_dtype=None):
        super().__init__()
        if truncate_at not in ("mixed_6e", "mixed_7c"):
            raise ValueError(f"truncate_at: mixed_6e or mixed_7c, not {truncate_at!r}")
        self.truncate_at, self.dtype = truncate_at, dtype
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        bc = partial(BasicConv2d, **kw)
        self.Conv2d_1a_3x3 = bc(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = bc(32, 32, 3)
        self.Conv2d_2b_3x3 = bc(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = bc(64, 80, 1)
        self.Conv2d_4a_3x3 = bc(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        if truncate_at == "mixed_7c":
            self.Mixed_7a = InceptionD(768, **kw)
            self.Mixed_7b = InceptionE(1280, **kw)
            self.Mixed_7c = InceptionE(2048, **kw)
        self.num_features = NUM_FEATURES_INCEPTION[f"inception_{truncate_at}"]

    def forward(self, x, train: bool = False):
        x = x.to(self.dtype)
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = getattr(self, name)(x, train)
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x, train), train)
        x = _max_pool_3x3_s2(x)
        blocks = ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"]
        if self.truncate_at == "mixed_7c":
            blocks += ["Mixed_7a", "Mixed_7b", "Mixed_7c"]
        for name in blocks:
            x = getattr(self, name)(x, train)
        return x
