"""Shared configuration and device helpers."""
