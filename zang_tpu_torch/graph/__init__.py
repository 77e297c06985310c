"""The chunked offline renderer and the fidelity metric."""
