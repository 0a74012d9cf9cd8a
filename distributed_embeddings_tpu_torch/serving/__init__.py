"""Lookup-only serving."""
