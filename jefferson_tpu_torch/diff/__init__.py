"""Differentiable rendering on torch autograd: source localization and HRTF
personalization."""
