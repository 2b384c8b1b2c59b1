from gangealing_torch.io.from_jax import params_from_jax  # noqa: F401
