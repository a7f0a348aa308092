"""The traffic generator: the same seed gives the same items, another seed
other items, every item distinct, and the pool sized from the window."""

import torch

from benchmark import traffic as tf

T = {"batch": 3, "image_size": 8, "classes": 10, "items_per_second": 4, "extra_items": 2}


def test_same_seed_same_items():
    a, b = tf.make_pool(T, 2 ** 31 + 7, 1.0, pin=False), tf.make_pool(T, 2 ** 31 + 7, 1.0, pin=False)
    assert torch.equal(a.images, b.images) and torch.equal(a.labels, b.labels)


def test_other_seed_other_items():
    a, b = tf.make_pool(T, 11, 1.0, pin=False), tf.make_pool(T, 12, 1.0, pin=False)
    assert not torch.equal(a.images, b.images)
    assert not torch.equal(a.labels, b.labels)


def test_items_distinct_and_sized():
    p = tf.make_pool(T, 5, 2.0, pin=False)
    assert len(p) == 2 * 4 + 2
    assert p.images.shape == (10, 3, 8, 8, 3) and p.images.dtype == torch.uint8
    flat = p.images.reshape(len(p), -1)
    assert all(not torch.equal(flat[i], flat[j]) for i in range(len(p)) for j in range(i))
    assert int(p.labels.min()) >= 0 and int(p.labels.max()) < 10


def test_item_depends_on_seed_and_index_only():
    short, long = tf.make_pool(T, 9, 1.0, pin=False), tf.make_pool(T, 9, 3.0, pin=False)
    assert torch.equal(short.images, long.images[: len(short)])


def test_feed_walks_the_pool_in_order():
    p = tf.make_pool(T, 3, 0.5, pin=False)
    feed = tf.Feed(p, torch.device("cpu"))
    got = [feed.next() for _ in range(len(p) + 1)]
    assert [i for i, _, _ in got] == list(range(len(p))) + [0]
    assert torch.equal(got[1][1], p.images[1])
    assert torch.equal(tf.to_pixels(torch.tensor([0, 255], dtype=torch.uint8)), torch.tensor([-1.0, 1.0]))
