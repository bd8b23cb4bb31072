"""Utilities of the port: :mod:`.test_utils` holds the metric test harness."""
