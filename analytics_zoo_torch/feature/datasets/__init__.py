"""Datasets: MovieLens (``movielens``)."""
