"""The serving layer: the ASR and TTS apps and the services below them.
aiohttp and aiortc are imported only where an application is built or
served."""
