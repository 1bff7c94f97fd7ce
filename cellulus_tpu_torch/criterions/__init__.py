"""Training objectives."""

from .oce_loss import oce_loss

__all__ = ["oce_loss"]
