"""The complete user journey, end to end, in one script.

Port of `examples/full_pipeline.py`: raw string-keyed interactions →
vocabularies → native-threaded batching (`native/loader.cc`, built with
g++ at first use) → two-tower training → corpus-level FactorizedTopK
evaluation → checkpoint save/restore → serving export (`torch.export`,
where the JAX package writes StableHLO) → standalone serving queries
decoded back to raw ids. Every subsystem a reference (TFRS) user would
touch, through the port's public API.

    python -m recommenders_tpu_torch.examples.full_pipeline [--device cpu]
"""

import tempfile

import numpy as np
import torch

from recommenders_tpu_torch import data, models
from recommenders_tpu_torch.data import vocab as vocab_lib
from recommenders_tpu_torch.examples import adagrad, parse_args
from recommenders_tpu_torch.examples.quickstart import build_model
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.models import retrieval as retrieval_model
from recommenders_tpu_torch.utils import checkpoint as ckpt_lib
from recommenders_tpu_torch.utils import device as device_lib
from recommenders_tpu_torch.utils import export as export_lib


def main(epochs: int = 2, device="cuda"):
    device = device_lib.resolve(device)
    # 1. Raw data with string ids, as it would arrive from logs.
    ds = data.synthetic_movielens(num_interactions=60_000)
    raw = {
        "user": np.asarray([f"user_{u}" for u in ds.user_ids]),
        "movie": np.asarray([f"movie_{m}" for m in ds.movie_ids]),
    }

    # 2. Vocabularies (the Keras StringLookup adapt step).
    user_vocab = vocab_lib.build_vocabulary(raw["user"])
    movie_vocab = vocab_lib.build_vocabulary(raw["movie"])
    encoded = {
        "user_id": user_vocab.encode(raw["user"]).astype(np.int32),
        "movie_id": movie_vocab.encode(raw["movie"]).astype(np.int32),
    }
    print(
        f"vocabularies: {user_vocab.size} users, "
        f"{movie_vocab.size} movies"
    )

    # 3. Train with the native (C++) threaded batcher.
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(user_vocab.size, movie_vocab.size, device, generator)
    trainer = models.Trainer(model, adagrad(0.5))
    batcher = data.batched_native_or_python(
        encoded, 4096, shuffle=True, seed=0
    )
    state = trainer.init(generator, next(iter(batcher())))
    state, history = trainer.fit(state, batcher, epochs=epochs)

    # 4. Corpus-level evaluation.
    candidate_batch = {
        "movie_id": np.arange(movie_vocab.size, dtype=np.int32)
    }
    results = retrieval_model.evaluate_with_corpus_metrics(
        trainer,
        state,
        data.batched(encoded, 4096),
        candidate_batch,
        ks=(10, 100),
    )
    for name, value in results.items():
        print(f"{name}: {value:.4f}")

    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        # 5. Checkpoint round trip.
        ckpt_lib.save(f"{tmp}/ckpt", state)
        state = ckpt_lib.restore(f"{tmp}/ckpt", template=state)
        print("checkpoint restored")

        # 6. Serving export: index the corpus, serialize, reload, query.
        model.eval()
        candidates = model.candidate_embeddings(
            {"movie_id": torch.arange(movie_vocab.size, device=device)})
        index = factorized_top_k.BruteForce(k=5, device=device).index(
            candidates)
        export_lib.export_index(
            f"{tmp}/serving", index,
            model.query_embeddings(
                {"user_id": torch.tensor([1], device=device)}),
            k=5,
        )
        serve = export_lib.load_index(f"{tmp}/serving")

        # 7. Standalone serving for a raw user id, decoded back.
        query_user = raw["user"][0]
        user_id = user_vocab.encode(np.asarray([query_user]))
        query_emb = model.query_embeddings(
            {"user_id": torch.from_numpy(user_id.astype(np.int64)).to(
                device)})
        scores, ids = serve(query_emb)
        recommended = movie_vocab.decode(ids[0].cpu().numpy())
        print(f"recommendations for {query_user}: {list(recommended)}")
    return {**results, "loss": history["epochs"][-1]["loss"],
            "users": user_vocab.size, "movies": movie_vocab.size,
            "recommended": [str(m) for m in recommended]}


if __name__ == "__main__":
    main(device=parse_args().device)
