"""PyTorch/CUDA port of the stream-processing auto-tuner (``repro``).

Mirrors the reference package's layout — each module has its twin at the
same relative path — and imports neither ``jax`` nor anything of ``repro``.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``,
where every hand-written kernel runs its plain torch version.
"""
