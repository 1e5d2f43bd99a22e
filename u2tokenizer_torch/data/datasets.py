"""Dataset layer: jsonl-driven multimodal datasets and batching
(counterpart of ``u2tokenizer_tpu/data/datasets.py``).

The reference's src/dataset/fused_dataset.py semantics, kept exactly:

  * prompt = chat_template("<im_patch>" * n_img + question) (fused_dataset.py:126-133)
  * input_id/label right-padded to max_length; eos written at the first pad
    slot; labels mask the question span and padding to -100
    (fused_dataset.py:153-188)
  * question_ids = the raw question alone (the μ²tokenizer's text condition)
  * dpo_mode returns {prompt, chosen, rejected, image}
    (fused_dataset.py:134-151)
  * a volume that fails to read is replaced by a random other index
    (fused_dataset.py:121-122)

The volume transforms run on ``device`` (the GPU unless the caller names
another); every tensor an item or a batch holds comes out on the CPU, and
the trainers move it. Token arrays are int64, attention masks int32.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .transforms import LinearVolumeTransform, U2VolumeTransform

IGNORE_INDEX = -100


def load_jsonl(path: str) -> List[dict]:
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                data.append(json.loads(line))
            except json.JSONDecodeError:
                print("Error loading json line:", line[:120])
    return data


class FusedDataset:
    """Map-style dataset over a jsonl of {image, question, answer}
    (or {..., chosen, rejected} for DPO)."""

    def __init__(
        self,
        base_path: str,
        jsonl_path: str,
        tokenizer,
        max_length: int,
        image_tokens_num: int = 256,
        data_type: str = "training",
        enable_u2tokenizer: bool = True,
        use_chat_template: bool = True,
        dpo_mode: bool = False,
        return_image: bool = True,
        num_chunks: int = 8,
        chunk_depth: int = 32,
        target_size: int = 256,
        seed: Optional[int] = None,
        device="cuda",
        item_seed: Optional[int] = None,
    ):
        self.base_path = base_path
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_tokens = "<im_patch>" * image_tokens_num
        self.data_type = data_type
        self.use_chat_template = use_chat_template
        self.dpo_mode = dpo_mode
        self.return_image = return_image
        self.annotations = load_jsonl(os.path.join(base_path, jsonl_path))
        self._rng = random.Random(seed)
        self.item_seed = item_seed
        self.epoch = 0

        if return_image:
            if enable_u2tokenizer:
                self.image_transform = U2VolumeTransform(
                    data_type=data_type, target_size=target_size,
                    chunk_depth=chunk_depth, num_chunks=num_chunks, seed=seed,
                    device=device)
            else:
                self.image_transform = LinearVolumeTransform(
                    data_type=data_type, device=device)

    def __len__(self) -> int:
        return len(self.annotations)

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose items the next reads are (``DataLoader``)."""
        self.epoch = epoch

    def _item_draws(self, idx: int):
        """With ``item_seed``, the training augmentations' draws of item
        ``idx`` in this epoch from a generator of their own, seeded by
        (item_seed, epoch, idx): the same whichever rank, thread or order
        reads it (every rank of a mesh, and one process alone, augment a
        row alike); else None, the transform's own stream."""
        if self.item_seed is None:
            return None
        from .transforms import TorchDraws

        key = np.random.SeedSequence([self.item_seed, self.epoch, idx])
        return TorchDraws(int(key.generate_state(1, np.uint64)[0] >> 1))

    # --- tokenization helpers (reference-parity) ---

    def _pad_right(self, ids: List[int]) -> torch.Tensor:
        ids = ids[: self.max_length]
        out = torch.full((self.max_length,), self.tokenizer.pad_token_id,
                         dtype=torch.int64)
        out[: len(ids)] = torch.tensor(ids, dtype=torch.int64)
        return out

    def _encode(self, text: str):
        ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
        n = min(len(ids), self.max_length)
        padded = self._pad_right(ids)
        mask = torch.zeros(self.max_length, dtype=torch.int32)
        mask[:n] = 1
        return padded, mask, n

    def _build_prompt(self, question: str) -> str:
        content = self.image_tokens + question
        if self.use_chat_template:
            return self.tokenizer.apply_chat_template(
                [{"role": "user", "content": content}],
                tokenize=False, add_generation_prompt=True)
        return content

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        ann = self.annotations[idx]
        prompt_question = ann["question"]
        image_path = os.path.join(self.base_path, ann["image"])

        if self.return_image:
            if not os.path.exists(image_path):
                print(f"Image file not found: {image_path}")
                return None
            try:
                image = self.image_transform(image_path,
                                             self._item_draws(idx)).cpu()
            except Exception:
                # corrupted sample: resample (fused_dataset.py:121-122)
                return self[self._rng.randint(0, len(self) - 1)]
        else:
            image = image_path

        question = self._build_prompt(prompt_question)

        if self.dpo_mode:
            q_ids, _, _ = self._encode(prompt_question)
            return {
                "image": image,
                "prompt_question_ids": q_ids,
                "prompt": question,
                "chosen": ann.get("chosen"),
                "rejected": ann.get("rejected"),
            }

        answer = ann["answer"]
        input_id, attention_mask, valid_len = self._encode(question + answer)
        if valid_len < self.max_length:
            input_id[valid_len] = self.tokenizer.eos_token_id

        _, _, question_len = self._encode(question)
        question_ids, _, _ = self._encode(prompt_question)

        label = input_id.clone()
        label[:question_len] = IGNORE_INDEX
        label[label == self.tokenizer.pad_token_id] = IGNORE_INDEX
        if (self.tokenizer.pad_token_id == self.tokenizer.eos_token_id
                and valid_len < self.max_length):
            label[valid_len] = self.tokenizer.eos_token_id

        return {
            "image": image,
            "image_path": image_path,
            "input_id": input_id,
            "label": label,
            "attention_mask": attention_mask,
            "question": question,
            "question_ids": question_ids,
            "prompt_question": prompt_question,
            "answer": answer,
            "question_type": ann.get("question_type", "Caption"),
        }


def collate_batch(samples: Sequence[Optional[dict]],
                  question_ids_len: Optional[int] = None) -> Optional[dict]:
    """Stack samples into a batch dict of CPU tensors (reference
    DataCollator, train_stage1.py:230-251). Drops None samples
    (ct_rate_dataset.py:155-168)."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    batch = {
        "images": torch.stack([torch.as_tensor(s["image"])
                               for s in samples]).float(),
        "input_ids": torch.stack([s["input_id"] for s in samples]),
        "labels": torch.stack([s["label"] for s in samples]),
        "attention_mask": torch.stack([s["attention_mask"] for s in samples]),
        "question_ids": torch.stack([s["question_ids"] for s in samples]),
    }
    if question_ids_len is not None:
        batch["question_ids"] = batch["question_ids"][:, :question_ids_len]
    return batch


class DataLoader:
    """Threaded prefetching loader over a map-style dataset: numpy's
    ``default_rng(seed + epoch)`` shuffles each epoch's order, which
    ``process_index``/``process_count`` stride into disjoint shards.

    On a mesh every rank draws the same global order and batches of the
    global ``batch_size`` (the JAX CLI's ``batch_size x data x fsdp``, one
    JAX process over all devices), and ``rows`` (``sft.BatchSlicer.rows``)
    picks the rank's rows of each batch, which alone are read and
    collated."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_workers: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 collate_fn=collate_batch, rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.collate_fn = collate_fn
        self.rows = rows
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_order(self) -> List[np.ndarray]:
        """The next epoch's batches of indices (advances the epoch)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        order = order[self.process_index::self.process_count]
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]
        return batches

    def __iter__(self) -> Iterator[dict]:
        import concurrent.futures as cf

        batches = self.batch_order()
        if self.num_workers <= 1:
            for idxs in batches:
                batch = self.collate_fn([self.dataset[int(i)] for i in idxs])
                if batch is not None:
                    yield batch
            return

        # Only per-item work runs on the pool; batches are assembled on the
        # consumer thread. A task that waited on other tasks of the same
        # pool (whole batches calling pool.map) would deadlock once every
        # worker held one while their items queued behind them.
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def submit_batch(idxs) -> List[cf.Future]:
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in idxs]

            pending: List[List[cf.Future]] = []
            it = iter(batches)
            for _ in range(min(2 * self.num_workers, len(batches))):
                pending.append(submit_batch(next(it)))
            for idxs in it:
                futs = pending.pop(0)
                batch = self.collate_fn([f.result() for f in futs])
                pending.append(submit_batch(idxs))
                if batch is not None:
                    yield batch
            for futs in pending:
                batch = self.collate_fn([f.result() for f in futs])
                if batch is not None:
                    yield batch
