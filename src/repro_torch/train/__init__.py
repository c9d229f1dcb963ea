"""Streaming online learning over signature chunks (``online``)."""
