"""Losses, optimizers and the train step."""
