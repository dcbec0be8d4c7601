"""Candidate selection and the active-search loop."""
