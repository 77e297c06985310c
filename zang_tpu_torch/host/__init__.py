"""Instruments, the Bach song and the render_wav CLI."""
