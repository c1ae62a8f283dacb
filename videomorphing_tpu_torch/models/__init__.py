"""Configured morph models."""
