"""Prediction and the serving step."""
