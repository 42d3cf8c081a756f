"""State dicts in the layouts of the reference's released checkpoints, for
the importers' tests and chip_smoke.py: torch module trees named after the
module trees the importers map (foreground_segmentation/cgnet.py's
Context_Guided_Network, lmffnet.py's LMFFNet, UCN's two torchvision-named
ResNet-34-8s branches), with the reference's shapes. Only the names and
shapes are the reference's; no forward is defined. `seeded_state` moves
every tensor by seeded noise. Imports torch only.
"""

import torch
import torch.nn as tnn


def seeded_state(module, seed):
    """The module's state dict as numpy arrays, drawn at the scales of a
    trained net: kernels LeCun-normal (std 1 / sqrt(fan_in)), biases N(0,
    0.1^2), the other float tensors (norm scales and means, PReLU slopes)
    their defaults moved by 0.1 noise, BatchNorm variances in [0.5, 1.5).
    Every value comes from `seed` alone."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif v.is_floating_point() and v.dim() >= 2:
            v = torch.randn(v.shape, generator=g) / v[0].numel() ** 0.5
        elif k.endswith("bias"):
            v = 0.1 * torch.randn(v.shape, generator=g)
        elif v.is_floating_point():
            v = v + 0.1 * torch.randn(v.shape, generator=g)
        out[k] = v.numpy()
    return out


def _mod(**children):
    m = tnn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _conv(cin, cout, k=3, groups=1):
    """A module holding one bias-free `conv`."""
    return _mod(conv=tnn.Conv2d(cin, cout, k, groups=groups, bias=False))


# --- CGNet: Context_Guided_Network(classes, in_channel, M, N) -----------------

def _cg_bnprelu(c):
    return _mod(bn=tnn.BatchNorm2d(c, eps=1e-3), act=tnn.PReLU(c))


def _cg_cbp(cin, cout, k):
    m = _cg_bnprelu(cout)
    m.conv = tnn.Conv2d(cin, cout, k, bias=False)
    return m


def _cg_fglo(c, r):
    return _mod(fc=tnn.Sequential(tnn.Linear(c, c // r), tnn.ReLU(), tnn.Linear(c // r, c),
                                  tnn.Sigmoid()))


def _cg_block_down(cin, n, r):
    return _mod(conv1x1=_cg_cbp(cin, n, 3), F_loc=_conv(n, n, groups=n),
                F_sur=_conv(n, n, groups=n), bn=tnn.BatchNorm2d(2 * n, eps=1e-3),
                act=tnn.PReLU(2 * n), reduce=_conv(2 * n, n, 1), F_glo=_cg_fglo(n, r))


def _cg_block(c, r):
    n = c // 2
    return _mod(conv1x1=_cg_cbp(c, n, 1), F_loc=_conv(n, n, groups=n),
                F_sur=_conv(n, n, groups=n), bn_prelu=_cg_bnprelu(c), F_glo=_cg_fglo(c, r))


def cgnet_twin(m=3, n=21, classes=2, cin=4):
    return _mod(
        level1_0=_cg_cbp(cin, 32, 3), level1_1=_cg_cbp(32, 32, 3), level1_2=_cg_cbp(32, 32, 3),
        b1=_cg_bnprelu(32 + cin), level2_0=_cg_block_down(32 + cin, 64, 8),
        level2=tnn.ModuleList([_cg_block(64, 8) for _ in range(m - 1)]),
        bn_prelu_2=_cg_bnprelu(128 + cin), level3_0=_cg_block_down(128 + cin, 128, 16),
        level3=tnn.ModuleList([_cg_block(128, 16) for _ in range(n - 1)]),
        bn_prelu_3=_cg_bnprelu(256), classifier=tnn.Sequential(_conv(256, classes, 1)))


# --- LMFFNet(classes, block_1, block_2) ---------------------------------------

def _lm_bnprelu(c):
    return _mod(bn=tnn.BatchNorm2d(c, eps=1e-3), acti=tnn.PReLU(c))


def _lm_conv(cin, cout, k=3, groups=1, bn_acti=False):
    m = _conv(cin, cout, k, groups)
    if bn_acti:
        m.bn_prelu = _lm_bnprelu(cout)
    return m


def _lm_semb(c):
    return _mod(conv3x3=_lm_conv(c, c // 2, bn_acti=True),
                dconv_left=_lm_conv(c // 4, c // 4, groups=c // 4, bn_acti=True),
                dconv_right=_lm_conv(c // 4, c // 4, groups=c // 4, bn_acti=True),
                conv3x3_resume=_mod(conv3x3=_lm_conv(c // 2, c // 2, bn_acti=True),
                                    conv1x1_resume=_lm_conv(c // 2, c, 1)),
                bn_relu_1=_lm_bnprelu(c))


def _lm_ffmb(skip, c):
    se = _mod(fc=tnn.Sequential(tnn.Linear(skip, skip // 8, bias=False), tnn.PReLU(),
                                tnn.Linear(skip // 8, skip, bias=False), tnn.Sigmoid()))
    return _mod(PMCA=_mod(conv2x2=_conv(skip, skip, 2, groups=skip), SE_Block=se),
                bn_prelu=_lm_bnprelu(c), conv1x1=_lm_conv(c, c, 1))


def _lm_sem_blocks(k, n, c):
    seq = tnn.Sequential()
    for i in range(n):
        seq.add_module(f"SEM_Block_{k}{i}", _lm_semb(c))
    return _mod(SEM_B_Block=seq)


def lmffnet_twin(block_1=3, block_2=8, classes=3, cin=6):
    c_a, c_b1, c_b2 = 32 + cin, 128 + cin, 256 + cin
    return _mod(
        Init_Block=_mod(init_conv=tnn.Sequential(*(_lm_conv(a, 32, bn_acti=True)
                                                   for a in (cin, 32, 32)))),
        FFM_A=_mod(bn_prelu=_lm_bnprelu(c_a), conv1x1=_lm_conv(c_a, c_a, 1)),
        downsample_1=_mod(conv3x3=_lm_conv(c_a, 64 - c_a), bn_prelu=_lm_bnprelu(64)),
        SEM_B_Block1=_lm_sem_blocks(1, block_1, 64), FFM_B1=_lm_ffmb(64, c_b1),
        downsample_2=_mod(conv3x3=_lm_conv(c_b1, 128), bn_prelu=_lm_bnprelu(128)),
        SEM_B_Block2=_lm_sem_blocks(2, block_2, 128), FFM_B2=_lm_ffmb(128, c_b2),
        MAD=_mod(mid_layer_1x1=_lm_conv(c_b1, 16, 1), deep_layer_1x1=_lm_conv(c_b2, 32, 1),
                 DwConv1=_lm_conv(48, 48, groups=48, bn_acti=True),
                 PwConv1=_lm_conv(48, classes, 1),
                 DwConv2=_lm_conv(c_b2, c_b2, groups=c_b2, bn_acti=True),
                 PwConv2=_lm_conv(c_b2, classes, 1)))


# --- UCN: two ResNet-34-8s branches -------------------------------------------

def _basic_block(cin, cout, downsample):
    m = _mod(conv1=tnn.Conv2d(cin, cout, 3, bias=False), bn1=tnn.BatchNorm2d(cout),
             conv2=tnn.Conv2d(cout, cout, 3, bias=False), bn2=tnn.BatchNorm2d(cout))
    if downsample:
        m.downsample = tnn.Sequential(tnn.Conv2d(cin, cout, 1, bias=False),
                                      tnn.BatchNorm2d(cout))
    return m


def resnet34_8s_twin(embed=64):
    """torchvision's ResNet-34 names (conv1, bn1, layer1-4 of BasicBlocks,
    downsample) with the 1x1 `fc` embedding head: one UCN branch."""
    m = _mod(conv1=tnn.Conv2d(3, 64, 7, bias=False), bn1=tnn.BatchNorm2d(64))
    cin = 64
    for i, (cout, n) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
        setattr(m, f"layer{i + 1}", tnn.Sequential(*(
            _basic_block(cin if b == 0 else cout, cout, b == 0 and cin != cout)
            for b in range(n))))
        cin = cout
    m.fc = tnn.Conv2d(512, embed, 1)
    return m


def ucn_twin(embed=16, rgb="rgb_fcn", depth="depth_fcn"):
    return _mod(**{rgb: resnet34_8s_twin(embed), depth: resnet34_8s_twin(embed)})
