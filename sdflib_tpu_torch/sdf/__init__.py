"""SDF structures: the exact and approximate octrees, the uniform grid and
the brute-force oracle."""
