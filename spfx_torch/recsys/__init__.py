"""The ALS/iALS recommender (port of spfx/recsys): interaction data and the
model."""
