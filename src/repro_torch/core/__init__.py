"""Core physics of the port: NBTI aging, the Table-1 temperature model
and process variation (copies of `repro.core.{aging,temperature,
variation}`). The policies, mapping, idling and the `CoreManager` join
with the event engine (ROADMAP A3)."""
from repro_torch.core import aging, temperature, variation

__all__ = ["aging", "temperature", "variation"]
