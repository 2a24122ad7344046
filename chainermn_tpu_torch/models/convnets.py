"""Classic ImageNet convnets (reference ``examples/imagenet`` archs).

The port of ``chainermn_tpu.models.convnets``: AlexNet, NIN, VGG16 and
GoogLeNet (inception-v1), the ``--arch`` choices of the ImageNet example
beside ResNet-50.  The same links, seeds and parameter paths as the JAX
models, so a JAX snapshot loads (``serializers.npz``) and both start from
bit-identical weights.  NCHW, fp32, as there.  ``input_norm="imagenet"``
standardizes raw uint8 pixels on the device (``models.resnet.
normalize_input``).  ``Linear(None, out)`` after the last pool flattens
NCHW in C, H, W order (``F.linear``'s rule), as the JAX link does.
"""

from __future__ import annotations

from .._device import resolve_device
from ..core.config import config
from ..core.link import Chain
from ..nn import functions as F
from ..nn import links as L
from .resnet import _input_consts, normalize_input

__all__ = ["AlexNet", "NIN", "VGG16", "GoogLeNet"]


class AlexNet(Chain):
    """AlexNet (reference example ``alex.py``), 227 x 227 inputs."""

    insize = 227

    def __init__(self, n_classes=1000, seed=0, input_norm=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._in_consts = _input_consts(input_norm, device)
        kw = dict(device=device)
        s = lambda k: seed + k  # noqa: E731
        self.conv1 = L.Convolution2D(3, 96, 11, stride=4, seed=s(0), **kw)
        self.conv2 = L.Convolution2D(96, 256, 5, pad=2, seed=s(1), **kw)
        self.conv3 = L.Convolution2D(256, 384, 3, pad=1, seed=s(2), **kw)
        self.conv4 = L.Convolution2D(384, 384, 3, pad=1, seed=s(3), **kw)
        self.conv5 = L.Convolution2D(384, 256, 3, pad=1, seed=s(4), **kw)
        self.fc6 = L.Linear(None, 4096, seed=s(5), **kw)
        self.fc7 = L.Linear(4096, 4096, seed=s(6), **kw)
        self.fc8 = L.Linear(4096, n_classes, seed=s(7), **kw)

    def forward(self, x):
        x = normalize_input(x, self._in_consts, "NCHW", None)
        h = F.max_pooling_2d(F.local_response_normalization(
            F.relu(self.conv1(x))), 3, stride=2)
        h = F.max_pooling_2d(F.local_response_normalization(
            F.relu(self.conv2(h))), 3, stride=2)
        h = F.relu(self.conv3(h))
        h = F.relu(self.conv4(h))
        h = F.max_pooling_2d(F.relu(self.conv5(h)), 3, stride=2)
        h = F.dropout(F.relu(self.fc6(h)))
        h = F.dropout(F.relu(self.fc7(h)))
        return self.fc8(h)


class NIN(Chain):
    """Network-in-Network (reference example ``nin.py``), 227 x 227."""

    insize = 227

    def __init__(self, n_classes=1000, seed=0, input_norm=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._in_consts = _input_consts(input_norm, device)
        s = lambda k: seed + k  # noqa: E731

        def mlpconv(in_ch, out_ch, ksize, stride, pad, k):
            return [L.Convolution2D(in_ch, out_ch, ksize, stride=stride,
                                    pad=pad, seed=s(k), device=device),
                    L.Convolution2D(out_ch, out_ch, 1, seed=s(k + 1),
                                    device=device),
                    L.Convolution2D(out_ch, out_ch, 1, seed=s(k + 2),
                                    device=device)]

        for layers, name in zip([mlpconv(3, 96, 11, 4, 0, 0),
                                 mlpconv(96, 256, 5, 1, 2, 10),
                                 mlpconv(256, 384, 3, 1, 1, 20)],
                                ["mlp1", "mlp2", "mlp3"]):
            for j, layer in enumerate(layers):
                setattr(self, f"{name}_{j}", layer)
        self.out_0 = L.Convolution2D(384, n_classes, 3, pad=1, seed=s(30),
                                     device=device)
        self.out_1 = L.Convolution2D(n_classes, n_classes, 1, seed=s(31),
                                     device=device)
        self.out_2 = L.Convolution2D(n_classes, n_classes, 1, seed=s(32),
                                     device=device)
        self.n_classes = n_classes

    def _mlp(self, prefix, h):
        for j in range(3):
            h = F.relu(getattr(self, f"{prefix}_{j}")(h))
        return h

    def forward(self, x):
        x = normalize_input(x, self._in_consts, "NCHW", None)
        h = F.max_pooling_2d(self._mlp("mlp1", x), 3, stride=2)
        h = F.max_pooling_2d(self._mlp("mlp2", h), 3, stride=2)
        h = F.max_pooling_2d(self._mlp("mlp3", h), 3, stride=2)
        h = F.relu(self.out_0(h))
        h = F.relu(self.out_1(h))
        h = self.out_2(h)
        return F.global_average_pooling_2d(h)


class VGG16(Chain):
    """VGG-16 (reference ``L.VGG16Layers`` shape), 224 x 224."""

    insize = 224

    def __init__(self, n_classes=1000, seed=0, input_norm=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self._in_consts = _input_consts(input_norm, device)
        cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
               (128, 256), (256, 256), (256, 256), "M",
               (256, 512), (512, 512), (512, 512), "M",
               (512, 512), (512, 512), (512, 512), "M"]
        self._plan = []
        idx = 0
        for item in cfg:
            if item == "M":
                self._plan.append("M")
                continue
            in_ch, out_ch = item
            name = f"conv{idx}"
            setattr(self, name, L.Convolution2D(in_ch, out_ch, 3, pad=1,
                                                seed=seed + idx,
                                                device=device))
            self._plan.append(name)
            idx += 1
        self.fc6 = L.Linear(None, 4096, seed=seed + 100, device=device)
        self.fc7 = L.Linear(4096, 4096, seed=seed + 101, device=device)
        self.fc8 = L.Linear(4096, n_classes, seed=seed + 102, device=device)

    def forward(self, x):
        h = normalize_input(x, self._in_consts, "NCHW", None)
        for item in self._plan:
            if item == "M":
                h = F.max_pooling_2d(h, 2, stride=2, cover_all=False)
            else:
                h = F.relu(getattr(self, item)(h))
        h = F.dropout(F.relu(self.fc6(h)))
        h = F.dropout(F.relu(self.fc7(h)))
        return self.fc8(h)


class _Inception(Chain):
    """GoogLeNet inception block (1x1 / 3x3 / 5x5 / pool-proj)."""

    def __init__(self, in_ch, c1, r3, c3, r5, c5, pp, seed=0, device=None):
        super().__init__()
        s = lambda k: seed + k  # noqa: E731
        kw = dict(device=device)
        self.b1 = L.Convolution2D(in_ch, c1, 1, seed=s(0), **kw)
        self.b3r = L.Convolution2D(in_ch, r3, 1, seed=s(1), **kw)
        self.b3 = L.Convolution2D(r3, c3, 3, pad=1, seed=s(2), **kw)
        self.b5r = L.Convolution2D(in_ch, r5, 1, seed=s(3), **kw)
        self.b5 = L.Convolution2D(r5, c5, 5, pad=2, seed=s(4), **kw)
        self.bp = L.Convolution2D(in_ch, pp, 1, seed=s(5), **kw)

    def forward(self, x):
        a = F.relu(self.b1(x))
        b = F.relu(self.b3(F.relu(self.b3r(x))))
        c = F.relu(self.b5(F.relu(self.b5r(x))))
        d = F.relu(self.bp(F.max_pooling_2d(x, 3, stride=1, pad=1,
                                            cover_all=False)))
        return F.concat([a, b, c, d], axis=1)


class _AuxHead(Chain):
    """GoogLeNet auxiliary classifier (avg-pool 5/3 -> 1x1 conv -> fc)."""

    def __init__(self, in_ch, n_classes, seed=0, device=None):
        super().__init__()
        self.conv = L.Convolution2D(in_ch, 128, 1, seed=seed, device=device)
        self.fc1 = L.Linear(None, 1024, seed=seed + 1, device=device)
        self.fc2 = L.Linear(1024, n_classes, seed=seed + 2, device=device)

    def forward(self, x):
        if x.shape[2] >= 5 and x.shape[3] >= 5:
            h = F.average_pooling_2d(x, 5, stride=3)
        else:  # small inputs (tests, CIFAR-scale)
            h = F.global_average_pooling_2d(x)[:, :, None, None]
        h = F.relu(self.conv(h))
        h = F.relu(self.fc1(h))
        return self.fc2(F.dropout(h, 0.7))


class GoogLeNet(Chain):
    """GoogLeNet / inception-v1 (reference example ``googlenet.py``),
    224 x 224, with the train-time auxiliary heads at inc4a and inc4d:
    ``forward`` returns the main logits, ``forward_with_aux`` the triple,
    ``loss`` main + 0.3 (aux1 + aux2) in training, main alone
    otherwise."""

    insize = 224

    def __init__(self, n_classes=1000, seed=0, aux_heads=True,
                 input_norm=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.aux_heads = aux_heads
        self._in_consts = _input_consts(input_norm, device)
        s = lambda k: seed + 1000 * k  # noqa: E731
        kw = dict(device=device)
        if aux_heads:
            self.aux1 = _AuxHead(512, n_classes, seed=s(20), **kw)
            self.aux2 = _AuxHead(528, n_classes, seed=s(21), **kw)
        self.conv1 = L.Convolution2D(3, 64, 7, stride=2, pad=3, seed=s(1),
                                     **kw)
        self.conv2r = L.Convolution2D(64, 64, 1, seed=s(2), **kw)
        self.conv2 = L.Convolution2D(64, 192, 3, pad=1, seed=s(3), **kw)
        self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32, s(4), **kw)
        self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64, s(5), **kw)
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64, s(6), **kw)
        self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64, s(7), **kw)
        self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64, s(8), **kw)
        self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64, s(9), **kw)
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128, s(10),
                                **kw)
        self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128, s(11),
                                **kw)
        self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128, s(12),
                                **kw)
        self.fc = L.Linear(1024, n_classes, seed=s(13), **kw)

    def _features(self, x):
        x = normalize_input(x, self._in_consts, "NCHW", None)
        h = F.max_pooling_2d(F.relu(self.conv1(x)), 3, stride=2, pad=1,
                             cover_all=False)
        h = F.relu(self.conv2(F.relu(self.conv2r(h))))
        h = F.max_pooling_2d(h, 3, stride=2, pad=1, cover_all=False)
        h = self.inc3b(self.inc3a(h))
        h = F.max_pooling_2d(h, 3, stride=2, pad=1, cover_all=False)
        h4a = self.inc4a(h)
        h4d = self.inc4d(self.inc4c(self.inc4b(h4a)))
        h = self.inc4e(h4d)
        h = F.max_pooling_2d(h, 3, stride=2, pad=1, cover_all=False)
        h = self.inc5b(self.inc5a(h))
        h = F.global_average_pooling_2d(h)
        h = F.dropout(h, 0.4)
        return self.fc(h), h4a, h4d

    def forward_with_aux(self, x):
        main, h4a, h4d = self._features(x)
        if not self.aux_heads:
            return main, None, None
        return main, self.aux1(h4a), self.aux2(h4d)

    def forward(self, x):
        return self._features(x)[0]

    def loss(self, x, t, aux_weight=0.3):
        """The reference's training objective: main + 0.3 (aux1 + aux2)."""
        main, a1, a2 = self.forward_with_aux(x)
        total = F.softmax_cross_entropy(main, t)
        if self.aux_heads and config.train:
            total = total + aux_weight * (
                F.softmax_cross_entropy(a1, t)
                + F.softmax_cross_entropy(a2, t))
        return total
