"""Common-English gate for post-OCR lexicon repair (copy of
``intool_rag_tpu/ocr/wordlist.py``).

Round-4 advisor finding: the confusion-pair and double-deletion repair
classes in :mod:`.rescore` could rewrite
correctly-spelled REAL words that happen to be out of the small serving
lexicon ('mate'→'rate' via the r↔m pair, 'deliver'→'delivered' via
del2). The unique-candidate gates bound ambiguity but not reality: a
real word with exactly one lexicon neighbour still got rewritten.

Fix: every word-rewrite class now additionally requires the SOURCE
token to be absent from this broader common-English wordlist. The list
is curated in-repo (this image has no /usr/share/dict, no hunspell, no
network), ~1.3k high-frequency lemmas plus the inflected forms that
collide with the serving lexicon's repair neighbourhoods. Coverage is
deliberately asymmetric-safe: a word MISSING from the list only means a
(possibly wrong) repair stays eligible under the unique-candidate gate,
while a word PRESENT can never be rewritten — so the list errs toward
inclusion of short common forms, the dangerous collision class.

No reference counterpart (the reference's CTC decode has no repair
layer at all, ch_ppocr_rec/utils.py:13-90).
"""

from __future__ import annotations

_BASE = """
a about above accept account across act add address after again against
age ago agree air all allow almost alone along already also although
always am among amount an and animal announce another answer any anyone
anything appear apple apply april area arm around arrive art article as
ask at august author auto autumn available average avoid away baby back
bad bag balance ball bank bar base basic be bear beat beautiful became
because become bed been before began begin behind being believe bell
below belt best better between big bill bird bit black block blood blue
board boat body bone book born both bottle bottom bought box boy brain
branch bread break bright bring broad broke brother brought brown build
built burn bus business but buy by call came camp can cannot capital
captain car card care carry case cat catch cause cell cent center
central century certain chair chance change character charge chart
check chief child children choice choose chose church circle city claim
class clean clear climb clock close cloth cloud coal coast coat cold
collect college color come common company compare complete computer
condition consider contain continue control cook cool copy corn corner
correct cost cotton could count country course court cover cow create
credit crop cross crowd current cut dad daily dance danger dark data
date daughter day dead deal dear death december decide decimal deep
degree deliver demand describe desert design desk detail develop did
die difference different difficult dinner direct direction discover
discuss distance divide do doctor does dog dollar done door double down
draw dream dress drink drive drop dry due during duty each ear early
earth east easy eat edge effect effort egg eight either electric
element else end enemy energy engine england english enough enter equal
escape especially even evening event ever every everyone everything
exact example except exercise expect experience experiment explain eye
face fact factor fail fair fall family famous far farm fast fat father
favor fear february feed feel feet fell felt few field fight figure
fill final find fine finger finish fire first fish fit five flat floor
flow flower fly follow food foot for force foreign forest form forward
found four frame free fresh friday friend from front fruit full fun
further future game garden gas gather gave general gentle get girl give
glad glass go goes gold gone good got govern government grand grass
gray great green grew ground group grow grown guess gun had hair half
hall hand happen happy hard has hat have he head hear heard heart heat
heavy held help her here high hill him his history hit hold hole home
hope horse hospital hot hour house how however huge human hundred hunt
hurry hurt i ice idea if important in inch include indicate industry
information insect instead interest into iron is island it its january
job join joy judge july jump june just keep kept key kill kind king
knew know known lady lake land language large last late later laugh law
lay lead learn least leave led left leg length less let letter level
lie life lift light like likely line list listen little live local
long look lost lot loud love low machine made mail main major make man
many map march mark market mass match mate material matter may maybe me
mean measure meat meet melody member men metal method middle might mile
milk million mind mine minute miss mix modern molecule moment monday
money month moon more morning most mother mountain mouth move much
music must my name nation natural nature near necessary neck need
never new news next night nine no noise noon nor north nose not note
nothing notice noun november now number object observe occur ocean
october of off offer office often oh oil old on once one only open
operate opinion or order organ original other our out over own oxygen
page paint pair paper paragraph parent park part party pass past
pattern pay people per perhaps period person phrase pick picture piece
place plain plan plane planet plant play please plural poem point pole
poor populate position possible post pound power practice prepare
present press pretty price print probable problem process produce
product program property protect prove provide public pull push put
question quick quiet quite race radio rail rain raise ran range rather
reach read ready real reason receive record red region remember repeat
reply represent require rest result return rich ride right ring rise
river road rock rode roll room root rope rose round row rub rule run
safe said sail salt same sand sat saturday save saw say scale school
science score sea search season seat second section see seed seem
segment self sell send sense sent sentence separate september serve
set settle seven several shall shape share sharp she sheet shell shine
shop shore short should shoulder shout show side sight sign silent
similar simple since sing single sister sit six size skill skin sky
sleep slip slow small smell smile snow so soft soil soldier solution
some son song soon sound south space speak special speech speed spell
spend spoke spot spread spring square stand star start state station
stay stead steam steel step stick still stone stood stop store story
straight strange stream street stretch string strong student study
subject substance subtract success such sudden suffix sugar suggest
suit summer sun sunday supply support sure surface surprise swim
syllable symbol system table tail take talk tall teach team teeth tell
temperature ten term test than thank that the their them then there
these they thick thin thing think third this those though thought
thousand three through throw thursday thus tie time tiny tire to
together told tone too took tool top total touch toward town track
trade train travel tree triangle trip trouble truck true try tube
tuesday turn twenty two type under unit until up upon us use usual
valley value vary verb very view village visit voice vowel wait walk
wall want war warm was wash watch water wave way we wear weather
wednesday week weight well went were west what wheel when where whether
which while white who whole whose why wide wife wild will win wind
window wing winter wire wish with within without woman women wonder
wood word wore work world would write written wrong wrote yard year
yes yet you young your
""".split()

# Inflected / derived forms in the repair classes' collision
# neighbourhoods (same length as, one-or-two chars short of, or a
# confusion-pair away from serving-lexicon words), plus business prose
# the serving lexicon's neighbours could capture.
_FORMS = """
acted added agreed aged aims arrived asked backed banks based bases
bears beats began begins bills boxes builds burned buses buyers buying
called calls cared cares carried cars cases causes cells chairs
changed changes charges checked checks chose cited claims classes
cleared closed closes codes comes cooked copies counted counts covers
crossed dated dates dealt deals deliver delivers denied derived died
dies dined dines doors dreams dressed drives dropped drops eaten ended
ends falls fared fares feeds feels fields files filed filled fills
finds fired fires fits fixed fixes flows forces formed forms funds
gained gains gates gives goods grades grants groups grows hands heads
hears heats helped helps holds homes hoped hopes hours houses joined
joins jumped keeps kinds lacks lands lasts leads leaves lined lines
lists lived lives loads loans looks loved loves mailed mails makes
marks means meets miles mines misses mixed mixes modes moved moves
named names needs notes offers opens orders owned owns paged pages
paid pairs parts passed passes pays picks placed places plans plants
plays pools ports posed poses posted posts pulls pushed pushes rates
rated reads refers rents rests rides rings rises risks roads rolls
rooms roots ropes rules runs sales saves scales scores seats sells
sends serves shapes shared shares sheets shines ships shops shows
sides signs sizes slips sorts sounds speaks spends spots stands stars
starts states stays steps sticks stops stored stores tells tends
tests ticks ties times tips tired tones tools tours trades trains
trees tries trips turns types units used uses views waits walks walls
wants wards wastes watches waves wears wished wishes words works
yards years mode rat rats ship dot dots
""".split()

COMMON_ENGLISH: frozenset[str] = frozenset(_BASE) | frozenset(_FORMS)


def is_common_word(token_lower: str) -> bool:
    """True when ``token_lower`` is a known real English word that the
    repair classes must never rewrite."""
    return token_lower in COMMON_ENGLISH
