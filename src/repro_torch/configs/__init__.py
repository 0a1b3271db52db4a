"""Deployment presets."""
