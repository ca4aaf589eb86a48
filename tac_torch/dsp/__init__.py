"""Filterbank and windows (counterpart of tac/dsp)."""
