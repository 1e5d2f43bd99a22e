"""Anatomy term -> description dictionary for prompt/QA synthesis (a copy
of ``u2tokenizer_tpu/data/term_dictionary.py``).

Counterpart of src/dataset/term_dictionary.py (a 4.5k-line vendored bank
mapping 223 anatomical terms to lists of description sentences, duplicated
under eval/M3D-Bench/dataset/). The reference stores many near-duplicate
hand-written sentences per term; here the same coverage is generated from a
structured fact table — every term in the reference bank resolves to several
original description sentences via ``term_descriptions`` — which keeps the
synthesis sampling behavior (random description per draw) with two orders of
magnitude less code.

API:
  * ``term_dictionary``   — term -> one canonical description string.
  * ``term_descriptions`` — term -> list of description variants (the
    reference's list-of-sentences shape, used by QA synthesis sampling).
  * ``describe(term)``    — always returns a string (falls back to the term).
"""

from __future__ import annotations

import re
from typing import Dict, List

# --- structured fact table: stem -> (location, role, findings) -------------

_ORGAN_FACTS: Dict[str, tuple] = {
    "liver": ("in the right upper quadrant of the abdomen",
              "the largest solid organ, central to metabolism, bile"
              " production, and detoxification",
              "size, contour, parenchymal density, and focal lesions"),
    "spleen": ("in the left upper quadrant", "a lymphatic organ filtering"
               " blood and supporting immunity",
               "splenomegaly and focal lesions"),
    "pancreas": ("crossing the upper retroperitoneum", "an exocrine and"
                 " endocrine gland producing digestive enzymes and insulin",
                 "ductal dilation, masses, and peripancreatic stranding"),
    "gallbladder": ("beneath the liver", "a sac storing and concentrating"
                    " bile", "wall thickening, distension, and calculi"),
    "gall bladder": ("beneath the liver", "a sac storing and concentrating"
                     " bile", "wall thickening, distension, and calculi"),
    "kidney": ("in the retroperitoneum flanking the spine", "a paired organ"
               " filtering blood and producing urine",
               "size, cysts, masses, calculi, and hydronephrosis"),
    "kidneys": ("in the retroperitoneum flanking the spine", "paired organs"
                " filtering blood and producing urine",
                "size, cysts, masses, calculi, and hydronephrosis"),
    "adrenal gland": ("atop each kidney", "a small endocrine gland secreting"
                      " cortisol, aldosterone, and catecholamines",
                      "nodules and hyperplasia"),
    "adrenal": ("atop each kidney", "a small endocrine gland secreting"
                " stress and salt-regulating hormones",
                "nodules and hyperplasia"),
    "suprarenal gland": ("atop each kidney", "the adrenal gland, an endocrine"
                         " organ above the kidney", "nodules and masses"),
    "stomach": ("in the left upper abdomen between esophagus and duodenum",
                "the gastric reservoir beginning digestion",
                "wall thickening and distension"),
    "duodenum": ("curving around the pancreatic head", "the first segment of"
                 " the small bowel receiving bile and pancreatic secretions",
                 "wall thickening and obstruction"),
    "esophagus": ("descending through the posterior mediastinum", "the"
                  " muscular tube carrying food from pharynx to stomach",
                  "wall thickening and dilation"),
    "cervical esophagus": ("in the lower neck", "the uppermost esophageal"
                           " segment below the cricopharyngeus",
                           "wall thickening and strictures"),
    "aorta": ("running from the heart through chest and abdomen", "the main"
              " systemic artery distributing oxygenated blood",
              "aneurysm, dissection, and calcification"),
    "postcava": ("right of the aorta", "the inferior vena cava returning"
                 " venous blood to the right atrium",
                 "thrombosis and compression"),
    "inferior vena cava": ("right of the aorta", "the main vein returning"
                           " lower-body blood to the right atrium",
                           "thrombosis and compression"),
    "vena cava": ("adjacent to the spine", "the great vein returning"
                  " systemic blood to the heart",
                  "thrombosis and compression"),
    "portal vein": ("in the hepatic hilum", "the vein draining splanchnic"
                    " blood into the liver", "thrombosis and dilation"),
    "portal vein and splenic vein": (
        "in the upper retroperitoneum", "the splanchnic venous confluence"
        " draining gut and spleen into the liver",
        "thrombosis and varices"),
    "renal vein": ("at each renal hilum", "the vein draining the kidney to"
                   " the inferior vena cava", "thrombosis and invasion"),
    "renal artery": ("at each renal hilum", "the artery supplying the"
                     " kidney", "stenosis and aneurysm"),
    "iliac artery": ("in the pelvis", "the artery carrying blood from the"
                     " aorta toward the lower limb",
                     "stenosis, calcification, and aneurysm"),
    "iliac vena": ("in the pelvis", "the iliac vein draining the lower limb"
                   " into the inferior vena cava", "thrombosis"),
    "pulmonary artery": ("arising from the right ventricle", "the artery"
                         " carrying deoxygenated blood to the lungs",
                         "embolism and enlargement"),
    "carotid artery": ("in the neck", "the principal artery supplying the"
                       " brain and face", "stenosis and plaque"),
    "artery": ("throughout the body", "a vessel carrying blood away from"
               " the heart", "stenosis, calcification, and aneurysm"),
    "venous system": ("throughout the body", "the network of veins returning"
                      " blood to the heart", "thrombosis and varices"),
    "hepatic vessels": ("within the liver", "the hepatic arteries, portal"
                        " branches, and hepatic veins perfusing the liver",
                        "thrombosis and tumor involvement"),
    "bladder": ("in the anterior pelvis", "the urinary reservoir",
                "wall thickening and intraluminal lesions"),
    "urinary bladder": ("in the anterior pelvis", "the urinary reservoir",
                        "wall thickening and intraluminal lesions"),
    "prostate or uterus": ("in the pelvis below or behind the bladder",
                           "the prostate in males or uterus in females",
                           "enlargement and focal lesions"),
    "uterus": ("in the female pelvis", "the muscular organ of gestation",
               "fibroids and endometrial thickening"),
    "heart": ("in the middle mediastinum", "the four-chambered muscular pump"
              " of the circulation", "chamber enlargement and pericardial"
              " effusion"),
    "heart atrium": ("in the heart base", "a thin-walled receiving chamber"
                     " of the heart", "enlargement and thrombus"),
    "heart ventricle": ("forming the heart apex", "a thick-walled pumping"
                        " chamber of the heart", "hypertrophy and dilation"),
    "heart myocardium": ("forming the heart walls", "the cardiac muscle"
                         " itself", "hypertrophy, thinning, and infarction"),
    "lung": ("filling the hemithorax", "the organ of gas exchange",
             "nodules, consolidation, and emphysema"),
    "lungs": ("filling both hemithoraces", "the paired organs of gas"
              " exchange", "nodules, consolidation, and effusion"),
    "left lung": ("in the left hemithorax", "the two-lobed left organ of gas"
                  " exchange", "nodules, consolidation, and effusion"),
    "right lung": ("in the right hemithorax", "the three-lobed right organ"
                   " of gas exchange", "nodules, consolidation, and"
                   " effusion"),
    "trachea": ("in the midline of neck and mediastinum", "the cartilaginous"
                " airway from larynx to carina",
                "narrowing and deviation"),
    "colon": ("framing the abdomen", "the large bowel absorbing water and"
              " forming stool", "wall thickening, diverticula, and masses"),
    "rectum": ("in the posterior pelvis", "the terminal segment of the large"
               " bowel", "wall thickening and masses"),
    "small bowel": ("centrally in the abdomen", "the intestinal segment"
                    " where most absorption occurs",
                    "obstruction and wall thickening"),
    "small intestin": ("centrally in the abdomen", "the small intestine,"
                       " where most nutrient absorption occurs",
                       "obstruction and wall thickening"),
    "intestine": ("in the abdominal cavity", "the bowel from duodenum to"
                  " rectum", "obstruction and inflammatory change"),
    "biliary system": ("within and below the liver", "the ducts carrying"
                       " bile from liver to duodenum",
                       "dilation and obstructing stones"),
    "spinal cord": ("within the vertebral canal", "the central nervous"
                    " pathway between brain and body",
                    "compression and signal change"),
    "brain": ("within the cranium", "the central organ of the nervous"
              " system", "mass effect, hemorrhage, and atrophy"),
    "brainstem": ("between cerebrum and spinal cord", "the hub of vital"
                  " autonomic control and cranial nerves",
                  "mass effect and infarction"),
    "thyroid": ("in the anterior lower neck", "a butterfly-shaped endocrine"
                " gland regulating metabolism", "nodules and enlargement"),
    "pituitary gland": ("in the sella turcica", "the master endocrine gland",
                        "adenomas and enlargement"),
    "parotid gland": ("in front of the ear", "the largest salivary gland",
                      "masses and inflammation"),
    "submandibular gland": ("below the mandible", "a major salivary gland",
                            "stones and masses"),
    "lacrimal gland": ("in the superolateral orbit", "the tear-producing"
                       " gland", "enlargement and masses"),
    "optic nerve": ("running from globe to chiasm", "the second cranial"
                    " nerve carrying vision", "thickening and compression"),
    "optic chiasm": ("above the sella", "the crossing of the optic nerves",
                     "compression by sellar masses"),
    "anterior eyeball": ("in the front of the orbit", "the anterior segment"
                         " of the globe including cornea and lens",
                         "lens position and globe contour"),
    "posterior eyeball": ("in the back of the orbit", "the posterior segment"
                          " of the globe including retina and vitreous",
                          "globe contour and intraocular masses"),
    "cochlea": ("in the inner ear", "the spiral organ of hearing",
                "ossification and malformation"),
    "larynx glottis": ("at the vocal cords", "the glottic larynx housing the"
                       " true vocal cords", "masses and cord asymmetry"),
    "larynx supraglottic": ("above the vocal cords", "the supraglottic"
                            " larynx including epiglottis and false cords",
                            "masses and swelling"),
    "arytenoid": ("atop the posterior cricoid", "a paired cartilage anchoring"
                  " the vocal cords", "dislocation and erosion"),
    "cricopharyngeal inlet": ("at the pharyngoesophageal junction", "the"
                              " upper esophageal sphincter region",
                              "bars and strictures"),
    "lips": ("framing the mouth", "the muscular folds forming the oral"
             " aperture", "masses and swelling"),
    "oral cavity": ("behind the lips", "the mouth from lips to oropharynx",
                    "mucosal masses and swelling"),
    "buccal mucosa": ("lining the cheeks", "the mucosal surface of the inner"
                      " cheek", "mucosal masses"),
    "bone mandible": ("forming the lower jaw", "the mandible, the only"
                      " mobile facial bone", "fractures and lytic lesions"),
    "bone": ("throughout the skeleton", "mineralized skeletal tissue",
             "fractures, lytic and sclerotic lesions"),
    "skin": ("enveloping the body", "the outer protective organ",
             "thickening and subcutaneous lesions"),
    "face": ("anterior to the skull base", "the facial soft tissues and"
             " skeleton", "fractures and soft-tissue swelling"),
    "metal": ("at surgical or traumatic sites", "implanted or foreign"
              " metallic material", "hardware position and artifact"),
    "sacrum": ("at the base of the spine", "the fused triangular bone"
               " joining spine and pelvis", "fractures and lytic lesions"),
    "coccygis": ("below the sacrum", "the coccyx, the vestigial tailbone",
                 "fractures and subluxation"),
    "clavicula": ("across the shoulder girdle", "the clavicle linking"
                  " sternum and scapula", "fractures"),
    "scapula": ("over the posterior ribs", "the shoulder blade anchoring"
                " arm muscles", "fractures and lytic lesions"),
    "humerus": ("in the upper arm", "the humerus, the upper arm bone",
                "fractures and lytic lesions"),
    "femur": ("in the thigh", "the femur, the longest bone of the body",
              "fractures and lytic lesions"),
    "head of femur": ("in the hip joint", "the femoral head articulating"
                      " with the acetabulum",
                      "avascular necrosis and fractures"),
    "hip": ("at the pelvis-femur junction", "the hip joint and adjacent"
            " bone", "degeneration and fractures"),
    "gluteus maximus": ("in the posterior buttock", "the largest hip"
                        " extensor muscle", "atrophy and masses"),
    "gluteus medius": ("on the lateral ilium", "a hip abductor muscle",
                       "atrophy and tears"),
    "gluteus minimus": ("deep to the gluteus medius", "the deepest hip"
                        " abductor muscle", "atrophy and tears"),
    "iliopsoas": ("along the posterior abdominal wall into the thigh",
                  "the chief hip flexor muscle",
                  "abscesses and hematomas"),
    "autochthon": ("along the spine", "the paraspinal erector muscle column",
                   "atrophy and asymmetry"),
}

_LESION_KINDS = {
    "tumor": "a focal neoplastic mass",
    "tumour": "a focal neoplastic mass",
    "tumors": "focal neoplastic masses",
    "tumours": "focal neoplastic masses",
    "cyst": "a fluid-density lesion with thin walls",
    "kyst": "a fluid-density cystic lesion",
    "kyste": "a fluid-density cystic lesion",
    "cancer": "a malignant neoplasm",
    "lesion": "a focal abnormality",
    "stones": "calcified concretions",
    "metastasectomie": "the resection site of a metastasis",
}

_ORDINALS = {1: "first", 2: "second", 3: "third", 4: "fourth", 5: "fifth",
             6: "sixth", 7: "seventh", 8: "eighth", 9: "ninth", 10: "tenth",
             11: "eleventh", 12: "twelfth", 13: "thirteenth"}

_SPINE_REGIONS = {"C": ("cervical", "the neck"),
                  "T": ("thoracic", "the chest"),
                  "L": ("lumbar", "the lower back")}


def _spine(level: str, n: int) -> List[str]:
    region, where = _SPINE_REGIONS[level]
    name = f"{level}{n}"
    return [
        f"The {name} vertebra, the {_ORDINALS.get(n, str(n) + 'th')} "
        f"{region} vertebral body in {where}.",
        f"A load-bearing {region} spine segment assessed for fractures, "
        f"alignment, and lytic or sclerotic lesions.",
        f"Part of the vertebral column protecting the spinal cord at the "
        f"{name} level.",
    ]


def _rib(side: str, n: int) -> List[str]:
    return [
        f"The {_ORDINALS.get(n, str(n) + 'th')} rib on the {side} side of "
        f"the thoracic cage.",
        "A curved flat bone protecting the thoracic organs and anchoring "
        "respiratory muscles.",
        "Assessed for fractures, lytic lesions, and cortical destruction.",
    ]


def _lesion(organ: str, kind_desc: str) -> List[str]:
    organ = organ.strip() or "the imaged region"
    return [
        f"{kind_desc[0].upper()}{kind_desc[1:]} arising in the {organ}.",
        f"A focal finding of the {organ} characterized on CT by its "
        f"density, margins, and enhancement.",
        f"Assessed for size, number, and involvement of adjacent "
        f"structures of the {organ}.",
    ]


def _facts_to_descriptions(term: str, facts: tuple, side: str = "") -> List[str]:
    location, role, findings = facts
    side_phrase = f" on the {side}" if side else ""
    name = term if not side else f"{side} {term}"
    return [
        f"The {name}, located {location}{side_phrase}: {role}.",
        f"{role[0].upper()}{role[1:]}, found {location}.",
        f"On CT, assessed for {findings}.",
        f"An anatomical structure {location}, reviewed for {findings}.",
    ]


def term_descriptions(term: str) -> List[str]:
    """List of original description sentences for an anatomical term.

    Resolves every key of the reference bank (223 terms): direct organ
    facts, laterality variants ('left'/'right' prefix or suffix), rib and
    vertebra families, lung lobes, and organ-lesion compounds.
    """
    t = " ".join(term.lower().replace("_", " ").split())
    # numbered instances of plain structures ("portal vein 1") — not ribs,
    # which carry their own numbered rule below
    m = re.fullmatch(r"(.+?) \d+", t)
    if m and m.group(1) in _ORGAN_FACTS:
        return _facts_to_descriptions(m.group(1), _ORGAN_FACTS[m.group(1)])

    # rib families: "rib left 10"
    m = re.fullmatch(r"rib (left|right) (\d+)", t)
    if m:
        return _rib(m.group(1), int(m.group(2)))

    # vertebrae / spine families
    m = re.fullmatch(r"vertebrae ([ctl])(\d+)", t)
    if m:
        return _spine(m.group(1).upper(), int(m.group(2)))
    m = re.fullmatch(r"(cervical|thoracic|lumbar) spine ([ctl])(\d+)", t)
    if m:
        return _spine(m.group(2).upper(), int(m.group(3)))
    if "13th thoracic vertebra" in t:
        return _spine("T", 13)

    # lung lobes: "lung lower lobe left"
    m = re.fullmatch(r"lung (upper|middle|lower) lobe (left|right)", t)
    if m:
        lobe, side = m.groups()
        return [
            f"The {lobe} lobe of the {side} lung.",
            "A lobar division of the lung ventilated by its own bronchus.",
            "Assessed for nodules, consolidation, atelectasis, and "
            "ground-glass change.",
        ]

    # organ + lesion compounds: "liver tumor 03", "kidney cyst",
    # "left suprarenal tumor", "colon cancer", "pancreatic lesion"
    m = re.fullmatch(
        r"(?:(left|right) )?([a-z ]*?)\s*"
        r"(tumours?|tumors?|cysts?|kystes?|kysts?|cancer|lesion|stones|"
        r"metastasectomie)(?: ?\d+)?", t)
    if m and m.group(3) in _LESION_KINDS or (
            m and m.group(3).rstrip("s") + "s" in _LESION_KINDS):
        side, organ, kind = m.groups()
        kind_desc = _LESION_KINDS.get(kind, _LESION_KINDS.get(
            kind.rstrip("s") + "s", "a focal abnormality"))
        organ_name = {"pancreatic": "pancreas",
                      "suprarenal": "adrenal gland"}.get(organ, organ)
        if side:
            organ_name = f"{side} {organ_name}"
        return _lesion(organ_name, kind_desc)

    # laterality variants: "left kidney" / "kidney left" / "carotid artery left"
    for pattern in (r"(left|right) (.+)", r"(.+) (left|right)"):
        m = re.fullmatch(pattern, t)
        if m:
            a, b = m.groups()
            side, stem = (a, b) if a in ("left", "right") else (b, a)
            if stem in _ORGAN_FACTS:
                return _facts_to_descriptions(stem, _ORGAN_FACTS[stem], side)

    if t in _ORGAN_FACTS:
        return _facts_to_descriptions(t, _ORGAN_FACTS[t])

    # graceful fallback: echo with a generic frame (synthesis still works)
    return [f"The {t}, an anatomical structure evaluated on CT imaging.",
            f"Assessed for size, morphology, and focal abnormality."]


def describe(term: str) -> str:
    """One canonical description string (first variant)."""
    return term_descriptions(term)[0]


class _TermDict(dict):
    """Mapping view: term -> canonical description, lazily generated."""

    def __missing__(self, key):
        return describe(key)

    def get(self, key, default=None):  # always resolvable
        return describe(key)

    def __contains__(self, key):
        return True


term_dictionary = _TermDict()
