"""Model zoo registry.

The port's own copy of gangealing_tpu/utils/download.py (``find_model``,
``PRETRAINED_TEST_HYPERPARAMS``; reference utils/download.py:10-38).
Names resolve against a local ``pretrained/`` directory only: nothing is
fetched.
"""

import os

VALID_MODELS = {"bicycle", "car", "cat", "cat_ssl_mix6", "celeba", "cub",
                "dog", "horse", "tvmonitor"}

# Published checkpoint base URL (reference download.py), named in the
# message of a missing model:
MODEL_BASE_URL = "http://efrosgans.eecs.berkeeley.edu/gangealing/pretrained"

# Test-time hyperparameters of the published pretrained models
# (reference utils/download.py:12-29).
_LSUN = {"flow_size": 128, "real_size": 256, "iters": 3,
         "padding_mode": "border"}
_SINGLE = {"flow_size": 128, "real_size": 256, "iters": 1,
           "padding_mode": "border"}
PRETRAINED_TEST_HYPERPARAMS = {
    "bicycle": {"num_heads": 1, **_LSUN},
    "car": {"num_heads": 4, **_LSUN},
    "cat": {"num_heads": 1, **_LSUN},
    "cat_ssl_mix6": {"num_heads": 1, **_LSUN},
    "celeba": {"num_heads": 1, **_SINGLE},
    "cub": {"num_heads": 1, **_SINGLE},
    "dog": {"num_heads": 1, **_LSUN},
    "horse": {"num_heads": 4, **_LSUN},
    "tvmonitor": {"num_heads": 1, **_LSUN},
}


def find_model(name_or_path):
    """Resolve a model zoo name or a local path -> (path, is_pretrained_name)
    (reference download.py:32-38)."""
    if name_or_path in VALID_MODELS:
        local = os.path.join("pretrained", f"{name_or_path}.pt")
        if os.path.exists(local):
            return local, True
        raise FileNotFoundError(
            f"pretrained model {name_or_path!r} is not available locally. "
            f"This environment has no network access; download "
            f"{MODEL_BASE_URL}/{name_or_path}.pt elsewhere and place it at "
            f"{local}.")
    if os.path.exists(name_or_path):
        return name_or_path, False
    raise FileNotFoundError(name_or_path)
