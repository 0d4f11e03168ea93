"""Uni-MoE-2.0-Omni's speech-to-text path (configuration, weights,
decoder with routed experts, and its plain float32 reference)."""
