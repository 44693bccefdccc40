"""Shakespeare corpus loading with a public-domain built-in fallback.

The port's own copy of ``tinydiffusionmodels_tpu/data/shakespeare.py``; both
packages read the same corpus (``tests/test_torch_package.py`` checks it).

Resolution order:
1. ``$TINY_SHAKESPEARE_PATH`` or ``<root>/tiny_shakespeare.txt`` /
   ``<root>/input.txt`` on disk (the karpathy char-rnn file works).
2. HF datasets ``tiny_shakespeare`` when importable and downloadable
   (reference src/shakespeare.py:122-125 behavior, joining all splits).
3. A built-in sampler of public-domain Shakespeare passages tiled to the
   requested size — keeps char-level training/benchmarks runnable hermetically.
"""

from __future__ import annotations

import os
from pathlib import Path

# Public-domain Shakespeare excerpts (First Folio-era text). Used only as a
# hermetic fallback corpus; clearly reported via the `source` return value.
_FALLBACK_PASSAGES = [
    """To be, or not to be, that is the question:
Whether 'tis nobler in the mind to suffer
The slings and arrows of outrageous fortune,
Or to take arms against a sea of troubles
And by opposing end them. To die: to sleep;
No more; and by a sleep to say we end
The heart-ache and the thousand natural shocks
That flesh is heir to, 'tis a consummation
Devoutly to be wish'd. To die, to sleep;
To sleep: perchance to dream: ay, there's the rub;
For in that sleep of death what dreams may come
When we have shuffled off this mortal coil,
Must give us pause.""",
    """All the world's a stage,
And all the men and women merely players:
They have their exits and their entrances;
And one man in his time plays many parts,
His acts being seven ages. At first the infant,
Mewling and puking in the nurse's arms.""",
    """Now is the winter of our discontent
Made glorious summer by this sun of York;
And all the clouds that lour'd upon our house
In the deep bosom of the ocean buried.
Now are our brows bound with victorious wreaths;
Our bruised arms hung up for monuments.""",
    """Friends, Romans, countrymen, lend me your ears;
I come to bury Caesar, not to praise him.
The evil that men do lives after them;
The good is oft interred with their bones;
So let it be with Caesar. The noble Brutus
Hath told you Caesar was ambitious:
If it were so, it was a grievous fault,
And grievously hath Caesar answer'd it.""",
    """Tomorrow, and tomorrow, and tomorrow,
Creeps in this petty pace from day to day
To the last syllable of recorded time,
And all our yesterdays have lighted fools
The way to dusty death. Out, out, brief candle!
Life's but a walking shadow, a poor player
That struts and frets his hour upon the stage
And then is heard no more: it is a tale
Told by an idiot, full of sound and fury,
Signifying nothing.""",
    """If music be the food of love, play on;
Give me excess of it, that, surfeiting,
The appetite may sicken, and so die.
That strain again! it had a dying fall:
O, it came o'er my ear like the sweet sound,
That breathes upon a bank of violets,
Stealing and giving odour!""",
    """O Romeo, Romeo! wherefore art thou Romeo?
Deny thy father and refuse thy name;
Or, if thou wilt not, be but sworn my love,
And I'll no longer be a Capulet.
'Tis but thy name that is my enemy;
Thou art thyself, though not a Montague.
What's Montague? it is nor hand, nor foot,
Nor arm, nor face, nor any other part
Belonging to a man. O, be some other name!""",
    """The quality of mercy is not strain'd,
It droppeth as the gentle rain from heaven
Upon the place beneath: it is twice blest;
It blesseth him that gives and him that takes:
'Tis mightiest in the mightiest: it becomes
The throned monarch better than his crown.""",
    """Once more unto the breach, dear friends, once more;
Or close the wall up with our English dead.
In peace there's nothing so becomes a man
As modest stillness and humility:
But when the blast of war blows in our ears,
Then imitate the action of the tiger;
Stiffen the sinews, summon up the blood.""",
]


def _fallback_corpus(min_chars: int) -> str:
    base = "\n\n".join(_FALLBACK_PASSAGES)
    reps = max(1, -(-min_chars // len(base)))
    return "\n\n".join([base] * reps)


def load_text_corpus(
    root: str | os.PathLike = "./data",
    *,
    allow_synthetic: bool = True,
    min_chars: int = 1_000_000,
) -> tuple[str, str]:
    """Return (corpus text, source). source: 'file', 'hf', or 'builtin'."""
    candidates = []
    env_path = os.environ.get("TINY_SHAKESPEARE_PATH")
    if env_path:
        candidates.append(Path(env_path))
    root = Path(root)
    candidates += [root / "tiny_shakespeare.txt", root / "input.txt"]
    for c in candidates:
        if c.is_file():
            return c.read_text(), "file"

    try:  # HF path, parity with reference src/shakespeare.py:122-125.
        # Hermetic-first: unless downloads are explicitly allowed, only use
        # an existing HF cache — a zero-egress pod would otherwise burn ~40s
        # of connection retries before falling back.
        if os.environ.get("TDM_ALLOW_DOWNLOADS") != "1":
            os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
            os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from datasets import load_dataset  # type: ignore

        ds = load_dataset("tiny_shakespeare", trust_remote_code=True)
        text = "\n\n".join(
            ds["train"]["text"] + ds["test"]["text"] + ds["validation"]["text"]
        )
        return text, "hf"
    except Exception:
        pass

    if not allow_synthetic:
        raise FileNotFoundError(
            "tiny_shakespeare not found on disk and HF download unavailable; "
            "set TINY_SHAKESPEARE_PATH"
        )
    return _fallback_corpus(min_chars), "builtin"
