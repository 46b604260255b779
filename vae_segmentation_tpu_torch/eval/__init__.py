"""Whole-crop evaluation of the Joint model."""
