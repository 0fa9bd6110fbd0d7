"""SPRITES, rotated-MNIST and moving-ball networks as torch nn.Modules
(port of svgpvae_tpu/nn/nets.py: the MNIST VAE, CVAE and deep-SVIGP
decoder, the SPRITES VAE, repr net and head, the ball MLPs; SPRITES in
the reference form only: 16 filters, plain convs).

Public methods take and return NHWC images, (b, 64, 64, 3) or
(b, 28, 28, 1), like the flax modules; the modules work in NCHW inside.
XLA's SAME padding is reproduced exactly: a 3x3 stride-2 conv on an even
size (64 -> 32 -> 16 -> 8 here) pads (0, 1), not (1, 1), so those convs
pad explicitly and use padding=0.  At stride 1 SAME is (1, 1).

Every constructor initialises as flax does (`init_like_flax_`): conv and
linear weights from lecun-normal, biases zero, drawn from the optional
`generator` (the global RNG without one).

The image nets take a compute dtype, `dtype`, with the meaning of flax's
`dtype=` (`cast_layer`): each conv and linear layer casts its input,
weight and bias to it and computes and returns in it, while the
parameters keep their own dtype (fp32 under --bf16, so autograd returns
fp32 gradients and Adam and the checkpoints stay fp32).  None computes in
the parameters' dtype.  `SpritesVAE` also takes `head_dtype`, the dtype of
its encoder head and output conv (--bf16_hybrid: fp32 heads on bf16
trunks); every image net's `set_compute_dtype` sets both.  The
elementwise ops between layers (elu, the upsampling, the pooling,
safe_exp) run in the dtype their input arrives in, as in flax.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

SAFE_EXP_CAP = 15.0
FILTERS = 16  # the reference's conv width
# std of the unit normal truncated to [-2, 2] (flax variance_scaling's
# "truncated_normal" divides by it, so the weights' variance is 1/fan_in)
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax's default initialisation, in place: every Conv2d and Linear
    weight from lecun_normal (variance_scaling(1, "fan_in",
    "truncated_normal"): a unit normal truncated at +-2, times
    sqrt(1 / fan_in) / TRUNC_STD; fan_in = in_channels * k_h * k_w or
    in_features), every bias zero.  The draws are float64 on the CPU from
    `generator`, layer by layer in definition order."""
    lo = 0.5 * math.erfc(math.sqrt(2.0))  # Phi(-2)
    for layer in module.modules():
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            continue
        w = layer.weight
        std = math.sqrt(1.0 / w.shape[1:].numel()) / TRUNC_STD
        u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
        x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo))
                                          - 1.0)
        w.copy_(std * x.clamp(-2.0, 2.0))
        if layer.bias is not None:
            layer.bias.zero_()
    return module


def safe_exp(x: Tensor) -> Tensor:
    """exp with a one-sided input cap (e^15 ~ 3e6 is far above every
    variance clip, so values in the operating range are unchanged)."""
    return torch.exp(torch.clamp(x, max=SAFE_EXP_CAP))


def cast_layer(layer: nn.Module, x: Tensor,
               dtype: Optional[torch.dtype] = None) -> Tensor:
    """A Conv2d or Linear applied as a flax layer with `dtype=` is: input,
    weight and bias cast to `dtype` (None: the weight's), the product in
    that dtype.  The casts are differentiable, so the parameters' gradients
    come back in their own dtype."""
    dt = dtype or layer.weight.dtype
    w = layer.weight.to(dt)
    b = None if layer.bias is None else layer.bias.to(dt)
    if isinstance(layer, nn.Conv2d):
        return F.conv2d(x.to(dt), w, b, layer.stride, layer.padding,
                        layer.dilation, layer.groups)
    return F.linear(x.to(dt), w, b)


class ComputeDtype:
    """The compute dtypes of an image net (see the module doc)."""

    def set_compute_dtype(self, dtype: Optional[torch.dtype],
                          head_dtype: Optional[torch.dtype] = None) -> None:
        """`dtype` for the layers, `head_dtype` (None: `dtype`) for
        SpritesVAE's heads."""
        self.dtype, self.head_dtype = dtype, head_dtype or dtype


def upsample2x(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x spatial upsampling, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def conv2d(*args, **kwargs) -> nn.Conv2d:
    """nn.Conv2d without torch's own initialisation (which would draw from
    the global RNG); `init_like_flax_` fills it."""
    return nn.utils.skip_init(nn.Conv2d, *args, **kwargs)


def linear(*args, **kwargs) -> nn.Linear:
    """nn.Linear without torch's own initialisation, as `conv2d`."""
    return nn.utils.skip_init(nn.Linear, *args, **kwargs)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    """3x3 conv; SAME padding is built in at stride 1, and applied by the
    caller (`same_pad_stride2`) at stride 2."""
    return conv2d(in_ch, out_ch, 3, stride=stride,
                  padding=1 if stride == 1 else 0)


def same_pad_stride2(x: Tensor) -> Tensor:
    """XLA SAME padding of a 3x3 stride-2 conv on an even size: (0, 1)."""
    return F.pad(x, (0, 1, 0, 1))


class SpritesVAE(ComputeDtype, nn.Module):
    """Conv VAE for 64x64x3 frames: encoder 6x Conv(16, 3, SAME, elu) with
    strides 1/2/1/2/1/2 -> Linear(2L); decoder Linear(1024) -> (16, 8, 8)
    -> 3x [up2 + 2x Conv(16, 3, SAME, elu)] -> Conv(3, 3, SAME) -> elu.

    The Linear layers use torch's (C, H, W) flatten order;
    utils.convert.params_from_jax permutes flax's (H, W, C) order to it.
    `dtype` is the compute dtype; `head_dtype` (None: `dtype`) that of
    enc_out and dec_out and of the last elu, as flax's SpritesVAE.
    """

    def __init__(self, L: int = 64,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None,
                 head_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.L = L
        self.set_compute_dtype(dtype, head_dtype)
        f = FILTERS
        self.enc_convs = nn.ModuleList(
            conv3x3(3 if i == 0 else f, f, stride=s)
            for i, s in enumerate((1, 2, 1, 2, 1, 2)))
        self.enc_out = linear(64 * f, 2 * L)
        self.dec_in = linear(L, 64 * f)
        self.dec_convs = nn.ModuleList(conv3x3(f, f) for _ in range(6))
        self.dec_out = conv3x3(f, 3)
        init_like_flax_(self, generator)

    def encode(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """NHWC images (b, 64, 64, 3) -> (mean (b, L), var (b, L))."""
        h = images.permute(0, 3, 1, 2)
        for conv in self.enc_convs:
            if conv.stride[0] == 2:
                h = same_pad_stride2(h)
            h = F.elu(cast_layer(conv, h, self.dtype))
        enc = cast_layer(self.enc_out, h.flatten(1), self.head_dtype)
        return enc[:, :self.L], safe_exp(enc[:, self.L:])

    def decode(self, latents: Tensor) -> Tensor:
        """(b, L) -> NHWC images (b, 64, 64, 3)."""
        h = cast_layer(self.dec_in, latents, self.dtype).view(
            -1, FILTERS, 8, 8)
        for i in range(3):
            h = upsample2x(h)
            h = F.elu(cast_layer(self.dec_convs[2 * i], h, self.dtype))
            h = F.elu(cast_layer(self.dec_convs[2 * i + 1], h, self.dtype))
        return F.elu(cast_layer(self.dec_out, h, self.head_dtype)).permute(
            0, 2, 3, 1)

    def forward(self, images: Tensor):
        mean, var = self.encode(images)
        return self.decode(mean), mean, var


class SpritesReprNet(ComputeDtype, nn.Module):
    """Character-style embedder: 3x Conv(L, 2, stride 2, elu) + 8x8 average
    pool -> (b, L) per frame, in the compute dtype `dtype`.  (SAME padding
    of a 2x2 stride-2 conv on an even size is zero.)"""

    def __init__(self, L: int = 16,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.L = L
        self.set_compute_dtype(dtype)
        self.convs = nn.ModuleList(
            conv2d(3 if i == 0 else L, L, 2, stride=2) for i in range(3))
        init_like_flax_(self, generator)

    def forward(self, images: Tensor) -> Tensor:
        """NHWC images (b, 64, 64, 3) -> (b, L)."""
        h = images.permute(0, 3, 1, 2)
        for conv in self.convs:
            h = F.elu(cast_layer(conv, h, self.dtype))
        return h.mean(dim=(2, 3))


class ClassificationHead(nn.Module):
    """Linear classifier stacked on the repr net for its pretraining:
    (b, in_features) embeddings -> (b, num_classes) logits, in the
    parameters' dtype (flax's fp32 head promotes the repr net's bf16
    embeddings under --bf16)."""

    def __init__(self, in_features: int, num_classes: int = 1000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = linear(in_features, num_classes)
        init_like_flax_(self, generator)

    def forward(self, embeddings: Tensor) -> Tensor:
        return cast_layer(self.dense, embeddings)


MNIST_FILTERS = 8  # the reference's conv width


class MnistVAE(ComputeDtype, nn.Module):
    """Conv VAE for rotated MNIST: encoder 3x Conv(8, 3, stride 2, VALID,
    elu) (28 -> 13 -> 6 -> 2) -> Linear(2L), split into mean and
    safe_exp(log-variance); decoder Linear(128) -> (8, 4, 4) -> up2 +
    Conv(8, 3, SAME) -> up2 + Conv(8, 3, VALID) -> up2 + Conv(1, 3, SAME),
    all elu.

    The Linear layers use torch's (C, H, W) flatten order;
    utils.convert.mnist_vae_state permutes flax's (H, W, C) order to it.
    `dtype` is the compute dtype.
    """

    def __init__(self, L: int = 16,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.L = L
        self.set_compute_dtype(dtype)
        f = MNIST_FILTERS
        self.enc_convs = nn.ModuleList(
            conv2d(1 if i == 0 else f, f, 3, stride=2) for i in range(3))
        self.enc_out = linear(4 * f, 2 * L)
        self.dec_in, self.dec_convs = mnist_decoder_layers(L)
        init_like_flax_(self, generator)

    def encode(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """NHWC images (b, 28, 28, 1) -> (mean (b, L), var (b, L))."""
        h = images.permute(0, 3, 1, 2)
        for conv in self.enc_convs:
            h = F.elu(cast_layer(conv, h, self.dtype))
        enc = cast_layer(self.enc_out, h.flatten(1), self.dtype)
        return enc[:, :self.L], safe_exp(enc[:, self.L:])

    def decode(self, latents: Tensor) -> Tensor:
        """(b, L) -> NHWC images (b, 28, 28, 1)."""
        return mnist_decode(self.dec_in, self.dec_convs, latents,
                            dtype=self.dtype)

    def forward(self, images: Tensor):
        mean, var = self.encode(images)
        return self.decode(mean), mean, var


def mnist_decoder_layers(L: int, in_maps: int = MNIST_FILTERS):
    """The MNIST decoder's Linear(L -> 128) and its three convs; the first
    conv takes `in_maps` channels (the CVAE appends 2 angle maps)."""
    f = MNIST_FILTERS
    return linear(L, 16 * f), nn.ModuleList([
        conv2d(in_maps, f, 3, padding=1), conv2d(f, f, 3),
        conv2d(f, 1, 3, padding=1)])


def mnist_decode(dec_in: nn.Linear, dec_convs: nn.ModuleList,
                 latents: Tensor, maps: Optional[Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> Tensor:
    """(b, L) -> (8, 4, 4) maps [+ `maps` (b, c, 4, 4) appended as
    channels] -> 3x [up2 + conv, elu] -> NHWC images (b, 28, 28, 1), in
    the compute dtype `dtype`."""
    h = cast_layer(dec_in, latents, dtype).view(-1, MNIST_FILTERS, 4, 4)
    if maps is not None:
        h = torch.cat([h, maps.to(h.dtype)], dim=1)
    for conv in dec_convs:
        h = F.elu(cast_layer(conv, upsample2x(h), dtype))
    return h.permute(0, 2, 3, 1)


def _sin_cos(angles: Tensor) -> Tensor:
    """(b,) angles -> (b, 2) [sin, cos]."""
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=1)


class MnistCVAE(ComputeDtype, nn.Module):
    """Conditional conv VAE for rotated MNIST: sin/cos of the rotation
    angle enter the encoder twice (as 2 input channels after the image,
    and beside the flattened features before Linear(2L)) and the decoder
    twice (beside the latents before Linear(128), and as 2 channels
    appended to the (8, 4, 4) maps, so the first decoder conv takes 10).

    `encode` takes the 3-channel NHWC input that models.vae.cvae_inputs
    builds ([image, sin map, cos map]).  The Linear layers use torch's
    (C, H, W) order; utils.convert.cvae_params_from_jax permutes flax's
    (H, W, C) order to it.  `dtype` is the compute dtype; the angles are
    cast to it before their sin and cos, as in flax.
    """

    def __init__(self, L: int = 16,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.L = L
        self.set_compute_dtype(dtype)
        f = MNIST_FILTERS
        self.enc_convs = nn.ModuleList(
            conv2d(3 if i == 0 else f, f, 3, stride=2) for i in range(3))
        self.enc_out = linear(4 * f + 2, 2 * L)
        self.dec_in, self.dec_convs = mnist_decoder_layers(L + 2, f + 2)
        init_like_flax_(self, generator)

    def encode(self, images3: Tensor, angles: Tensor
               ) -> Tuple[Tensor, Tensor]:
        """NHWC (b, 28, 28, 3), angles (b,) -> (mean (b, L), var (b, L))."""
        h = images3.permute(0, 3, 1, 2)
        for conv in self.enc_convs:
            h = F.elu(cast_layer(conv, h, self.dtype))
        sc = _sin_cos(angles.to(h.dtype))
        enc = cast_layer(self.enc_out, torch.cat([h.flatten(1), sc], 1),
                         self.dtype)
        return enc[:, :self.L], safe_exp(enc[:, self.L:])

    def decode(self, latents: Tensor, angles: Tensor) -> Tensor:
        """(b, L), angles (b,) -> NHWC images (b, 28, 28, 1)."""
        dt = self.dtype or self.dec_in.weight.dtype
        sc = _sin_cos(angles.to(dt))
        maps = sc[:, :, None, None].expand(-1, -1, 4, 4)
        return mnist_decode(self.dec_in, self.dec_convs,
                            torch.cat([latents.to(dt), sc], 1), maps,
                            dtype=self.dtype)

    def forward(self, images3: Tensor, angles: Tensor):
        mean, var = self.encode(images3, angles)
        return self.decode(mean, angles), mean, var


class SVIGPDecoder(nn.Module):
    """The deep-SVIGP baseline's decoder, MnistVAE's decoder alone: (b, L)
    GP posterior means -> NHWC images (b, 28, 28, 1)."""

    def __init__(self, L: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.L = L
        self.dec_in, self.dec_convs = mnist_decoder_layers(L)
        init_like_flax_(self, generator)

    def forward(self, latents: Tensor) -> Tensor:
        return mnist_decode(self.dec_in, self.dec_convs, latents)

    decode = forward


class BallEncoder(nn.Module):
    """Flattened frames -> tanh MLP -> per-frame 2-D mean and variance:
    (b, T, px, py) videos -> (mean (b, T, 2), var (b, T, 2)).  With
    `full_cholesky` the head is 2 (T + 1) wide and the variances are
    (b, T, 2T) stacked full-Cholesky rows.  Each frame is flattened in
    row-major (px, py) order, as the flax module reshapes."""

    def __init__(self, tmax: int = 30, px: int = 32, py: int = 32,
                 hidden: Sequence[int] = (500,), full_cholesky: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.full_cholesky = full_cholesky
        self.out_dim = 2 * (tmax + 1) if full_cholesky else 4
        widths = [px * py, *hidden]
        self.hidden = nn.ModuleList(linear(a, b)
                                    for a, b in zip(widths, widths[1:]))
        self.out = linear(widths[-1], self.out_dim)
        init_like_flax_(self, generator)

    def forward(self, vids: Tensor) -> Tuple[Tensor, Tensor]:
        b, t, px, py = vids.shape
        h = vids.reshape(b * t, px * py)
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        h = self.out(h).reshape(b, t, self.out_dim)
        return h[:, :, :2], safe_exp(h[:, :, 2:])


class BallDecoder(nn.Module):
    """2-D latents -> tanh MLP -> per-frame Bernoulli logits: (b, T, 2) ->
    (b, T, px, py)."""

    def __init__(self, px: int = 32, py: int = 32,
                 hidden: Sequence[int] = (500,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.px, self.py = px, py
        widths = [2, *hidden]
        self.hidden = nn.ModuleList(linear(a, b)
                                    for a, b in zip(widths, widths[1:]))
        self.out = linear(widths[-1], px * py)
        init_like_flax_(self, generator)

    def forward(self, latents: Tensor) -> Tensor:
        b, t, d = latents.shape
        h = latents.reshape(b * t, d)
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        return self.out(h).reshape(b, t, self.px, self.py)
