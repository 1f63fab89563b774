"""Evaluation of the port: metrics and the 05 evaluate-predictor protocol."""
