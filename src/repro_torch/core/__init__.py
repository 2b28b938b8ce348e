"""Ranking core: BM25, scorers, stages, the pipeline algebra and the planner."""
