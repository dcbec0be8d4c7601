"""In-repo model zoo for the task-extraction frontend (a copy of
``vae_extent_search_tpu/frontend/zoo.py``).

torchvision is not part of this image, so the benchmark-grid
architectures are defined here directly from their published
specifications (He et al. 2015 ResNet with the torchvision V1.5
convention — stride on the bottleneck 3x3, 1x1 projection shortcuts;
Sandler et al. 2018 MobileNetV2; Xie et al. 2016 ResNeXt-50 32x4d;
Zagoruyko & Komodakis 2016 Wide-ResNet-50-2; Radford et al. 2015 DCGAN
generator). Layer-for-layer these match what the reference's relay
importer sees when dump_network_info.py:27-62 loads the torchvision
models — the frontend test pins the traced task lists against
records/networks.py's shape tables.

Only the graph structure matters for task extraction (weights are
random); every model here is fx-traceable with a static graph.
"""

from __future__ import annotations

from typing import Callable, Dict


def _conv_bn(inp, out, k, s, p, groups=1):
    import torch.nn as nn

    return nn.Sequential(
        nn.Conv2d(inp, out, k, s, p, groups=groups, bias=False),
        nn.BatchNorm2d(out),
        nn.ReLU(inplace=True),
    )


def _make_resnet(block, layers, width_per_group=64, groups=1):
    import torch.nn as nn

    class BasicBlock(nn.Module):
        expansion = 1

        def __init__(self, inplanes, planes, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1,
                                   bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.relu = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.downsample = downsample

        def forward(self, x):
            idn = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return self.relu(out + idn)

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, inplanes, planes, stride=1, downsample=None):
            super().__init__()
            width = int(planes * (width_per_group / 64.0)) * groups
            self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(width)
            # V1.5: the stride lives on the 3x3 (torchvision semantics)
            self.conv2 = nn.Conv2d(width, width, 3, stride, 1,
                                   groups=groups, bias=False)
            self.bn2 = nn.BatchNorm2d(width)
            self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample

        def forward(self, x):
            idn = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return self.relu(out + idn)

    blk = BasicBlock if block == "basic" else Bottleneck

    class ResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inplanes = 64
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = self._layer(64, layers[0], 1)
            self.layer2 = self._layer(128, layers[1], 2)
            self.layer3 = self._layer(256, layers[2], 2)
            self.layer4 = self._layer(512, layers[3], 2)
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
            self.fc = nn.Linear(512 * blk.expansion, 1000)

        def _layer(self, planes, n, stride):
            downsample = None
            if stride != 1 or self.inplanes != planes * blk.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(self.inplanes, planes * blk.expansion, 1,
                              stride, bias=False),
                    nn.BatchNorm2d(planes * blk.expansion),
                )
            blocks = [blk(self.inplanes, planes, stride, downsample)]
            self.inplanes = planes * blk.expansion
            blocks += [blk(self.inplanes, planes) for _ in range(n - 1)]
            return nn.Sequential(*blocks)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = self.avgpool(x)
            return self.fc(x.flatten(1))

    return ResNet()


def _make_mobilenet_v2():
    import torch.nn as nn

    class InvertedResidual(nn.Module):
        def __init__(self, inp, out, stride, expand):
            super().__init__()
            hidden = inp * expand
            self.use_res = stride == 1 and inp == out
            layers = []
            if expand != 1:
                layers.append(_conv_bn(inp, hidden, 1, 1, 0))
            layers += [
                _conv_bn(hidden, hidden, 3, stride, 1, groups=hidden),
                nn.Conv2d(hidden, out, 1, 1, 0, bias=False),
                nn.BatchNorm2d(out),
            ]
            self.conv = nn.Sequential(*layers)

        def forward(self, x):
            return x + self.conv(x) if self.use_res else self.conv(x)

    # (expand t, channels c, repeats n, stride s) — MobileNetV2 table 2
    spec = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    class MobileNetV2(nn.Module):
        def __init__(self):
            super().__init__()
            feats = [_conv_bn(3, 32, 3, 2, 1)]
            c_in = 32
            for t, c, n, s in spec:
                for i in range(n):
                    feats.append(
                        InvertedResidual(c_in, c, s if i == 0 else 1, t))
                    c_in = c
            feats.append(_conv_bn(c_in, 1280, 1, 1, 0))
            self.features = nn.Sequential(*feats)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.classifier = nn.Linear(1280, 1000)

        def forward(self, x):
            x = self.pool(self.features(x))
            return self.classifier(x.flatten(1))

    return MobileNetV2()


def _make_dcgan(image_size: int = 64):
    """DCGAN generator (the reference's relay/testing/dcgan.py get_net,
    ngf=128): dense 100 -> 4*4*1024 (at the 64-px base), then four
    4x4/stride-2/pad-1 transposed convs halving channels to RGB."""
    import torch.nn as nn

    s4 = max(1, image_size // 16)

    class DCGAN(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(100, s4 * s4 * 1024)
            self.s4 = s4
            chans = [(1024, 512), (512, 256), (256, 128), (128, 3)]
            self.deconvs = nn.Sequential(*[
                nn.ConvTranspose2d(ci, co, 4, 2, 1, bias=False)
                for ci, co in chans
            ])

        def forward(self, z):
            x = self.fc(z).reshape(z.shape[0], 1024, self.s4, self.s4)
            return self.deconvs(x)

    return DCGAN()


def _make_mobilenet_v3_large():
    """MobileNetV3-Large (Howard et al. 2019 table 1, torchvision
    layout incl. squeeze-excite 1x1 convs and hardswish)."""
    import torch.nn as nn

    def _make_div(v, divisor=8):
        new = max(divisor, int(v + divisor / 2) // divisor * divisor)
        if new < 0.9 * v:
            new += divisor
        return new

    class SE(nn.Module):
        def __init__(self, ch):
            super().__init__()
            sq = _make_div(ch // 4)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc1 = nn.Conv2d(ch, sq, 1)
            self.relu = nn.ReLU(inplace=True)
            self.fc2 = nn.Conv2d(sq, ch, 1)
            self.hsig = nn.Hardsigmoid()

        def forward(self, x):
            s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
            return x * s

    class Bneck(nn.Module):
        def __init__(self, inp, k, exp, out, se, hs, stride):
            super().__init__()
            act = nn.Hardswish if hs else nn.ReLU
            layers = []
            if exp != inp:
                layers += [nn.Conv2d(inp, exp, 1, bias=False),
                           nn.BatchNorm2d(exp), act()]
            layers += [nn.Conv2d(exp, exp, k, stride, k // 2,
                                 groups=exp, bias=False),
                       nn.BatchNorm2d(exp), act()]
            if se:
                layers.append(SE(exp))
            layers += [nn.Conv2d(exp, out, 1, bias=False),
                       nn.BatchNorm2d(out)]
            self.block = nn.Sequential(*layers)
            self.use_res = stride == 1 and inp == out

        def forward(self, x):
            return x + self.block(x) if self.use_res else self.block(x)

    # (k, exp, out, SE, HS, stride)
    spec = [
        (3, 16, 16, False, False, 1),
        (3, 64, 24, False, False, 2),
        (3, 72, 24, False, False, 1),
        (5, 72, 40, True, False, 2),
        (5, 120, 40, True, False, 1),
        (5, 120, 40, True, False, 1),
        (3, 240, 80, False, True, 2),
        (3, 200, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 480, 112, True, True, 1),
        (3, 672, 112, True, True, 1),
        (5, 672, 160, True, True, 2),
        (5, 960, 160, True, True, 1),
        (5, 960, 160, True, True, 1),
    ]

    class MobileNetV3(nn.Module):
        def __init__(self):
            super().__init__()
            feats = [nn.Sequential(
                nn.Conv2d(3, 16, 3, 2, 1, bias=False),
                nn.BatchNorm2d(16), nn.Hardswish())]
            c_in = 16
            for k, exp, out, se, hs, s in spec:
                feats.append(Bneck(c_in, k, exp, out, se, hs, s))
                c_in = out
            feats.append(nn.Sequential(
                nn.Conv2d(c_in, 960, 1, bias=False),
                nn.BatchNorm2d(960), nn.Hardswish()))
            self.features = nn.Sequential(*feats)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc1 = nn.Linear(960, 1280)
            self.hs = nn.Hardswish()
            self.fc2 = nn.Linear(1280, 1000)

        def forward(self, x):
            x = self.pool(self.features(x)).flatten(1)
            return self.fc2(self.hs(self.fc1(x)))

    return MobileNetV3()


def _make_densenet_121():
    """DenseNet-121 (Huang et al. 2016; growth 32, blocks 6/12/24/16,
    bottleneck 4x growth, half-channel transitions)."""
    import torch
    import torch.nn as nn

    growth = 32

    class DenseLayer(nn.Module):
        def __init__(self, c_in):
            super().__init__()
            self.bn1 = nn.BatchNorm2d(c_in)
            self.conv1 = nn.Conv2d(c_in, 4 * growth, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(4 * growth)
            self.conv2 = nn.Conv2d(4 * growth, growth, 3, 1, 1,
                                   bias=False)
            self.relu = nn.ReLU(inplace=True)

        def forward(self, x):
            y = self.conv1(self.relu(self.bn1(x)))
            y = self.conv2(self.relu(self.bn2(y)))
            return torch.cat([x, y], 1)

    class Transition(nn.Module):
        def __init__(self, c_in):
            super().__init__()
            self.bn = nn.BatchNorm2d(c_in)
            self.relu = nn.ReLU(inplace=True)
            self.conv = nn.Conv2d(c_in, c_in // 2, 1, bias=False)
            self.pool = nn.AvgPool2d(2, 2)

        def forward(self, x):
            return self.pool(self.conv(self.relu(self.bn(x))))

    class DenseNet(nn.Module):
        def __init__(self):
            super().__init__()
            layers = [nn.Conv2d(3, 64, 7, 2, 3, bias=False),
                      nn.BatchNorm2d(64), nn.ReLU(inplace=True),
                      nn.MaxPool2d(3, 2, 1)]
            c = 64
            for bi, n in enumerate([6, 12, 24, 16]):
                for _ in range(n):
                    layers.append(DenseLayer(c))
                    c += growth
                if bi < 3:
                    layers.append(Transition(c))
                    c //= 2
            layers += [nn.BatchNorm2d(c), nn.ReLU(inplace=True)]
            self.features = nn.Sequential(*layers)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.classifier = nn.Linear(c, 1000)

        def forward(self, x):
            return self.classifier(
                self.pool(self.features(x)).flatten(1))

    return DenseNet()


def _make_inception_v3():
    """Inception-V3 (Szegedy et al. 2015, torchvision graph at 299 px,
    eval mode — no aux head)."""
    import torch
    import torch.nn as nn

    class C(nn.Module):  # conv-bn-relu
        def __init__(self, cin, cout, **kw):
            super().__init__()
            self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
            self.bn = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU(inplace=True)

        def forward(self, x):
            return self.relu(self.bn(self.conv(x)))

    class IncA(nn.Module):
        def __init__(self, cin, pool_feats):
            super().__init__()
            self.b1 = C(cin, 64, kernel_size=1)
            self.b5 = nn.Sequential(C(cin, 48, kernel_size=1),
                                    C(48, 64, kernel_size=5, padding=2))
            self.b3 = nn.Sequential(
                C(cin, 64, kernel_size=1),
                C(64, 96, kernel_size=3, padding=1),
                C(96, 96, kernel_size=3, padding=1))
            self.pool = nn.Sequential(
                nn.AvgPool2d(3, 1, 1), C(cin, pool_feats, kernel_size=1))

        def forward(self, x):
            return torch.cat(
                [self.b1(x), self.b5(x), self.b3(x), self.pool(x)], 1)

    class IncB(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.b3 = C(cin, 384, kernel_size=3, stride=2)
            self.b3dbl = nn.Sequential(
                C(cin, 64, kernel_size=1),
                C(64, 96, kernel_size=3, padding=1),
                C(96, 96, kernel_size=3, stride=2))
            self.pool = nn.MaxPool2d(3, 2)

        def forward(self, x):
            return torch.cat(
                [self.b3(x), self.b3dbl(x), self.pool(x)], 1)

    class IncC(nn.Module):
        def __init__(self, cin, c7):
            super().__init__()
            self.b1 = C(cin, 192, kernel_size=1)
            self.b7 = nn.Sequential(
                C(cin, c7, kernel_size=1),
                C(c7, c7, kernel_size=(1, 7), padding=(0, 3)),
                C(c7, 192, kernel_size=(7, 1), padding=(3, 0)))
            self.b7dbl = nn.Sequential(
                C(cin, c7, kernel_size=1),
                C(c7, c7, kernel_size=(7, 1), padding=(3, 0)),
                C(c7, c7, kernel_size=(1, 7), padding=(0, 3)),
                C(c7, c7, kernel_size=(7, 1), padding=(3, 0)),
                C(c7, 192, kernel_size=(1, 7), padding=(0, 3)))
            self.pool = nn.Sequential(
                nn.AvgPool2d(3, 1, 1), C(cin, 192, kernel_size=1))

        def forward(self, x):
            return torch.cat(
                [self.b1(x), self.b7(x), self.b7dbl(x), self.pool(x)], 1)

    class IncD(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.b3 = nn.Sequential(
                C(cin, 192, kernel_size=1),
                C(192, 320, kernel_size=3, stride=2))
            self.b7x3 = nn.Sequential(
                C(cin, 192, kernel_size=1),
                C(192, 192, kernel_size=(1, 7), padding=(0, 3)),
                C(192, 192, kernel_size=(7, 1), padding=(3, 0)),
                C(192, 192, kernel_size=3, stride=2))
            self.pool = nn.MaxPool2d(3, 2)

        def forward(self, x):
            return torch.cat(
                [self.b3(x), self.b7x3(x), self.pool(x)], 1)

    class IncE(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.b1 = C(cin, 320, kernel_size=1)
            self.b3_1 = C(cin, 384, kernel_size=1)
            self.b3_2a = C(384, 384, kernel_size=(1, 3), padding=(0, 1))
            self.b3_2b = C(384, 384, kernel_size=(3, 1), padding=(1, 0))
            self.bd_1 = nn.Sequential(
                C(cin, 448, kernel_size=1),
                C(448, 384, kernel_size=3, padding=1))
            self.bd_2a = C(384, 384, kernel_size=(1, 3), padding=(0, 1))
            self.bd_2b = C(384, 384, kernel_size=(3, 1), padding=(1, 0))
            self.pool = nn.Sequential(
                nn.AvgPool2d(3, 1, 1), C(cin, 192, kernel_size=1))

        def forward(self, x):
            b3 = self.b3_1(x)
            bd = self.bd_1(x)
            return torch.cat(
                [self.b1(x), self.b3_2a(b3), self.b3_2b(b3),
                 self.bd_2a(bd), self.bd_2b(bd), self.pool(x)], 1)

    class InceptionV3(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                C(3, 32, kernel_size=3, stride=2),
                C(32, 32, kernel_size=3),
                C(32, 64, kernel_size=3, padding=1),
                nn.MaxPool2d(3, 2),
                C(64, 80, kernel_size=1),
                C(80, 192, kernel_size=3),
                nn.MaxPool2d(3, 2),
            )
            self.blocks = nn.Sequential(
                IncA(192, 32), IncA(256, 64), IncA(288, 64),
                IncB(288),
                IncC(768, 128), IncC(768, 160), IncC(768, 160),
                IncC(768, 192),
                IncD(768),
                IncE(1280), IncE(2048),
            )
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(2048, 1000)

        def forward(self, x):
            return self.fc(
                self.pool(self.blocks(self.stem(x))).flatten(1))

    return InceptionV3()


def _make_resnet3d_18():
    """R3D-18 (Tran et al. 2017; torchvision r3d_18: all-3D stem
    (3,7,7)/s(1,2,2), BasicBlock3d layers 64/128/256/512)."""
    import torch.nn as nn

    class Basic3d(nn.Module):
        def __init__(self, cin, cout, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv3d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm3d(cout)
            self.conv2 = nn.Conv3d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm3d(cout)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample

        def forward(self, x):
            idn = x if self.downsample is None else self.downsample(x)
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            return self.relu(y + idn)

    class R3D18(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                          bias=False),
                nn.BatchNorm3d(64), nn.ReLU(inplace=True))
            layers = []
            cin = 64
            for cout, stride in [(64, 1), (128, 2), (256, 2), (512, 2)]:
                ds = None
                if stride != 1 or cin != cout:
                    ds = nn.Sequential(
                        nn.Conv3d(cin, cout, 1, stride, bias=False),
                        nn.BatchNorm3d(cout))
                layers += [Basic3d(cin, cout, stride, ds),
                           Basic3d(cout, cout)]
                cin = cout
            self.layers = nn.Sequential(*layers)
            self.pool = nn.AdaptiveAvgPool3d(1)
            self.fc = nn.Linear(512, 400)

        def forward(self, x):
            return self.fc(
                self.pool(self.layers(self.stem(x))).flatten(1))

    return R3D18()


def _make_vgg_16():
    """VGG-16 (Simonyan & Zisserman 2014, configuration D; torchvision
    ``vgg16`` without batch-norm: 3x3/pad-1 conv stacks 64x2 / 128x2 /
    256x3 / 512x3 / 512x3 with 2x2 max-pools, adaptive 7x7 avg-pool,
    4096-4096-1000 classifier — reference dump_network_info.py:46-48
    loads exactly this model)."""
    import torch.nn as nn

    class VGG16(nn.Module):
        def __init__(self):
            super().__init__()
            layers = []
            cin = 3
            for block in [[64, 64], [128, 128], [256, 256, 256],
                          [512, 512, 512], [512, 512, 512]]:
                for cout in block:
                    layers += [nn.Conv2d(cin, cout, 3, padding=1),
                               nn.ReLU(inplace=True)]
                    cin = cout
                layers.append(nn.MaxPool2d(2, 2))
            self.features = nn.Sequential(*layers)
            self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True),
                nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(inplace=True),
                nn.Dropout(),
                nn.Linear(4096, 1000))

        def forward(self, x):
            return self.classifier(
                self.avgpool(self.features(x)).flatten(1))

    return VGG16()


ZOO_BUILDERS: Dict[str, Callable] = {
    "resnet_18": lambda: _make_resnet("basic", [2, 2, 2, 2]),
    "resnet_50": lambda: _make_resnet("bottleneck", [3, 4, 6, 3]),
    "wide_resnet_50": lambda: _make_resnet(
        "bottleneck", [3, 4, 6, 3], width_per_group=128),
    "resnext_50": lambda: _make_resnet(
        "bottleneck", [3, 4, 6, 3], width_per_group=4, groups=32),
    "mobilenet_v2": _make_mobilenet_v2,
    "mobilenet_v3": _make_mobilenet_v3_large,
    "densenet_121": _make_densenet_121,
    "inception_v3": _make_inception_v3,
    "resnet3d_18": _make_resnet3d_18,
    "vgg_16": _make_vgg_16,
    "dcgan": _make_dcgan,
}


def build_zoo_model(name: str):
    """Instantiate a zoo architecture by grid name."""
    if name not in ZOO_BUILDERS:
        raise ValueError(
            f"no zoo builder for {name!r}; available: "
            f"{sorted(ZOO_BUILDERS)}")
    return ZOO_BUILDERS[name]()
