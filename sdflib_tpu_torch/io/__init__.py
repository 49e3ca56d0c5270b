"""Reference-format (.bin) serialization."""
