"""The recommender system (counterpart of
``paddle_tpu/models/recommender.py``; book ch. 05, reference:
v2/fluid/tests/book/test_recommender_system.py): a user tower (id, gender,
age, job) and a movie tower (id, categories, title) joined by a scaled
cosine similarity, regressed on the rating.
"""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer
from paddle_tpu_torch.dataset import movielens as ml


def build(emb_dim: int = 32, tower: int = 32, title_len: int = 5):
    uid = layer.data("user_id",
                     paddle.data_type.integer_value(ml.MAX_USER + 1))
    gender = layer.data("gender", paddle.data_type.integer_value(2))
    age = layer.data("age", paddle.data_type.integer_value(ml.NUM_AGES))
    job = layer.data("job", paddle.data_type.integer_value(ml.NUM_JOBS))
    mid = layer.data("movie_id",
                     paddle.data_type.integer_value(ml.MAX_MOVIE + 1))
    cats = layer.data("categories", paddle.data_type.integer_value_sequence(
        ml.NUM_CATEGORIES, max_len=3))
    title = layer.data("title", paddle.data_type.integer_value_sequence(
        ml.TITLE_VOCAB, max_len=title_len))
    rating = layer.data("score", paddle.data_type.dense_vector(1))

    usr = layer.concat([
        layer.embedding(uid, size=emb_dim),
        layer.embedding(gender, size=4),
        layer.embedding(age, size=4),
        layer.embedding(job, size=8),
    ])
    usr = layer.fc(usr, size=tower, act="tanh", name="user_tower")

    mov = layer.concat([
        layer.embedding(mid, size=emb_dim),
        layer.pooling(layer.embedding(cats, size=emb_dim),
                      pooling_type="sum"),
        layer.pooling(layer.embedding(title, size=emb_dim),
                      pooling_type="sum"),
    ])
    mov = layer.fc(mov, size=tower, act="tanh", name="movie_tower")

    sim = layer.cos_sim(usr, mov, scale=5.0, name="inference")
    cost = layer.square_error_cost(sim, rating, name="cost")
    return cost, sim
