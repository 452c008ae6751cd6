from .unet import ScoreUNet, build_model  # noqa: F401
