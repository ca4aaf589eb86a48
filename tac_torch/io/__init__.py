"""Audio file I/O (counterpart of tac/io)."""
