"""wis_tpu_torch — the PyTorch/CUDA port of ``wis_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, laid out like it so each module's
counterpart is easy to find:

    wis_tpu_torch.audio     — log-mel frontend, codecs (the native
                              wisaudio library), ingest, VAD
    wis_tpu_torch.models    — whisper, XTTS v2 and WavLM
    wis_tpu_torch.ops       — quantization, gelu, attention helpers and the
                              hand-written Hopper kernels (``csrc/``)
    wis_tpu_torch.decoding  — language detect, beam search, the ASR program
    wis_tpu_torch.runtime   — model registry, transcription engine and the
                              dynamic batcher
    wis_tpu_torch.parallel  — one engine replica per CUDA device
    wis_tpu_torch.server    — the ASR and TTS HTTP apps (a transport-free
                              core per route, aiohttp adapters), auth,
                              the OpenAPI document, WebRTC, the streaming
                              session, speaker verification
    wis_tpu_torch.settings  — settings from the environment
    wis_tpu_torch.utils     — the converter self-test, logging setup,
                              the edge-config checks
    wis_tpu_torch.bench     — the reference-table benchmark on the card
    wis_tpu_torch.entry     — ``entry()``: large-v2's forward step
    wis_tpu_torch.cli       — ``python -m wis_tpu_torch.cli run``,
                              ``run-tts``, ``convert-model``, ``bench``,
                              ``check`` and ``check-edge``

It imports ``torch`` and never ``jax``: nothing here loads the
``wis_tpu`` package, so it runs on a machine without JAX. aiohttp and
aiortc are imported only by the functions that build or serve a web
application (``server/rtc.py`` imports aiortc, as ``wis_tpu``'s does).
The JAX package is the reference the CPU tests hold this port against.
"""

from wis_tpu_torch.version import __version__

__all__ = ["__version__"]
