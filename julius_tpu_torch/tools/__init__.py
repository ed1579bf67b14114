"""Synthetic model builders."""
