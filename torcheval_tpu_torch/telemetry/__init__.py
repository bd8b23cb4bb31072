"""Telemetry for the port: the per-phase span hook only (see ``events``)."""

from torcheval_tpu_torch.telemetry import events

__all__ = ["events"]
