"""Seeded weights for the benchmark's models, drawn on the device.

The recipes' trained weights (``cat.pt``, ``car.pt``, the SimCLR VGG and
the LPIPS calibration) are not in the repository, and the work of a step
does not depend on their values. So each module's state is drawn from the
run's seed in one ``torch.randn`` call on the device and cut into its
leaves, each scaled by the rule ``leaf_rule`` gives for its name. The rules
keep the activations at the scale trained weights give them (He scaling for
the plain VGG convs, the equalised layers' own runtime scaling elsewhere)
and make every leaf that the models initialise to zero or one carry values
of its own, so that no path of the forward (noise, biases, the warp heads)
is the identity and the check covers it.
"""

import math
import re

import torch

# (pattern over the state_dict key, scale, offset, take the absolute value)
_RULES = (
    # StyleGAN2: the mapping MLP's EqualLinear stores its weight divided by
    # lr_mul (0.01) and multiplies its bias by it
    (r"^style\.\d+\.weight$", 100.0, 0.0, False),
    (r"^style\.\d+\.bias$", 10.0, 0.0, False),
    (r"\.modulation\.bias$", 0.1, 1.0, False),
    (r"\.noise\.weight$", 0.1, 0.0, False),
    (r"^noises\.noise_\d+$", 1.0, 0.0, False),
    # the STN's warp heads: small similarities and flows around the identity
    (r"warp_head\.linear\.weight$", 0.005, 0.0, False),
    (r"warp_head\.linear\.bias$", 0.05, 0.0, False),
    (r"warp_head\.flow_out\.2\.weight$", 0.05, 0.0, False),
    (r"warp_head\.flow_out\.2\.bias$", 0.01, 0.0, False),
    # the latent learner: unit-scale PCA directions, small coefficients
    (r"^directions$", None, 0.0, False),
    (r"^coefficients$", 0.1, 0.0, False),
    # LPIPS calibration layers: non-negative, as trained ones are
    (r"^lin\d\.model\.1\.weight$", 0.1, 0.0, True),
    # the VGG trunk's plain convs: He-initialised, small biases
    (r"^net\.slice\d\.\d+\.bias$", 0.01, 0.0, False),
    (r"^net\.slice\d\.\d+\.weight$", "he", 0.0, False),
    (r"\.bias$", 0.1, 0.0, False),
)


def leaf_rule(key, shape):
    """(scale, offset, absolute) of the leaf ``key`` of ``shape``."""
    for pattern, scale, offset, absolute in _RULES:
        if re.search(pattern, key):
            if scale == "he":
                scale = math.sqrt(2.0 / math.prod(shape[1:]))
            elif scale is None:  # rows of unit norm in expectation
                scale = 1.0 / math.sqrt(shape[-1])
            return scale, offset, absolute
    return 1.0, 0.0, False


def seeded_state(module, seed, stream, device):
    """A state_dict for ``module`` (its parameters and persistent buffers,
    by name and shape; the module itself may live on the meta device),
    drawn from (``seed``, ``stream``) in one call on ``device``."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed((int(seed) << 8) + stream)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        scale, offset, absolute = leaf_rule(key, shape)
        leaf = flat[at:at + n].view(shape)
        leaf = leaf.abs() if absolute else leaf
        out[key] = (leaf * scale + offset).contiguous()
        at += n
    return out
