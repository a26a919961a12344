"""Batched rocket-TVC environment as plain functions over tensor dataclasses."""
